"""Share of the window's tasks that ran inside a replayed task graph
(``Runtime.stats()``: replayed_tasks over tasks)."""
LAYER = "runtime and task-graph replay"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "program_counter", "jacobi_glups"


def read(run):
    tasks = run.counters.get("tasks")
    return 100.0 * run.counters["replayed_tasks"] / tasks if tasks else None
