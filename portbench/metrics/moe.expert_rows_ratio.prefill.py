"""The rows the MoE layers' expert products ran on over the rows routed to
experts (tokens x top_k), over the window's prefill batches
(``models.moe.COUNTS``): 8.0 where one card's dense fallback runs all 64
experts on every token that routes to 8, 1.0 for a dropless routed path.
A program without the counters gives nothing to read."""
LAYER = "model step"
UNIT, BETTER, SOURCE, MOVES = "x", "lower", "program_counter", \
    "prefill_tokens_s"


def read(run):
    routed = run.counters.get("routed_rows")
    return run.counters["computed_rows"] / routed if routed else None
