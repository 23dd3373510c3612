"""Interconnect topology model (paper §3.2.3 + §4.2).

The paper's message engine adapts its protocol to the link it is using:
small messages go eagerly, large ones are pipelined in chunks sized so
that network receive and device copy overlap. Both decisions need the
same thing — a per-link estimate of bandwidth and latency — and so does
the scheduler's transfer-cost model (ROADMAP follow-up b: the gravity
penalty must come from measured bandwidth, not a fixed byte constant).

``InterconnectModel`` is that single estimate. Endpoints are integers:
``HOST`` (-1) for host memory, device ids inside one runtime, or rank ids
when the distributed ``Cluster`` models its network. Every estimate is a
``LinkEstimate`` holding exponentially-weighted moving averages of
bandwidth and latency, seeded by a cheap startup micro-probe
(``Runtime`` with ``topology_probe=True``) and refined online by
``observe`` calls from every real transfer the runtime performs. The
model is deliberately clock-free: callers pass ``(nbytes, seconds)``
samples, so tests can drive it deterministically.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import sanitizer
from repro_torch.core.hetero_object import HOST

# defaults before any sample arrives: a conservative PCIe-gen3-ish link.
DEFAULT_BANDWIDTH = 8e9          # bytes/s
DEFAULT_LATENCY = 20e-6          # seconds
# samples shorter than this are treated as latency measurements; the
# bandwidth term of such a transfer is noise (dispatch dominates).
_LATENCY_SAMPLE_BYTES = 4 << 10
_MIN_SECONDS = 1e-9

# adaptive credit-window controller (AIMD): the receiver's transfer-lane
# queue depth and landing-slab occupancy arrive with every credit; a
# backlog at or above WINDOW_BACKLOG_DEPTH chunks — or landing slabs
# holding more than WINDOW_SLAB_LIMIT bytes — halves the window (never
# below 1), an empty queue widens it by one chunk toward the BDP ceiling.
WINDOW_BACKLOG_DEPTH = 2
WINDOW_SLAB_LIMIT = 32 << 20


class LinkEstimate:
    """EWMA bandwidth/latency for one directed (src, dst) link.
    Latency and bandwidth first-samples are tracked separately: a link
    whose first traffic is small (latency-only) messages must still have
    its first REAL bandwidth sample replace the default outright, not be
    blended 3:1 with the guess."""

    __slots__ = ("bandwidth", "latency", "samples", "bw_samples",
                 "lat_samples", "chunk_choice", "window_choice")

    def __init__(self, bandwidth: float = DEFAULT_BANDWIDTH,
                 latency: float = DEFAULT_LATENCY):
        self.bandwidth = bandwidth
        self.latency = latency
        self.samples = 0          # total observations (either kind)
        self.bw_samples = 0
        self.lat_samples = 0
        # sticky chunk-size choice per (target_s, lo, hi) — see
        # InterconnectModel.chunk_bytes hysteresis
        self.chunk_choice: Dict[Tuple[float, int, int], int] = {}
        # adaptive credit-window controller state (window_chunks with
        # receiver feedback); None until the first adaptive decision
        self.window_choice: Optional[int] = None

    def cost_s(self, nbytes: int) -> float:
        """Predicted transfer time: latency + nbytes / bandwidth."""
        return self.latency + nbytes / max(self.bandwidth, 1.0)


class InterconnectModel:
    """Directed-link bandwidth/latency estimates with EWMA refinement.

    ``alpha`` weights new samples; the first sample replaces the default
    outright (a measured number always beats the guess).
    """

    def __init__(self, alpha: float = 0.25,
                 default_bandwidth: float = DEFAULT_BANDWIDTH,
                 default_latency: float = DEFAULT_LATENCY):
        self.alpha = alpha
        self._default_bw = default_bandwidth
        self._default_lat = default_latency
        self._links: Dict[Tuple[int, int], LinkEstimate] = {}
        self._lock = sanitizer.make_lock("InterconnectModel._lock")

    def _link(self, src: int, dst: int) -> LinkEstimate:
        key = (src, dst)
        est = self._links.get(key)
        if est is None:
            est = LinkEstimate(self._default_bw, self._default_lat)
            self._links[key] = est
        return est

    # -- refinement ----------------------------------------------------
    def observe(self, src: int, dst: int, nbytes: int,
                seconds: float) -> None:
        """Fold one real transfer into the (src → dst) estimate. Tiny
        transfers update latency (their duration is dispatch-dominated);
        larger ones update bandwidth after subtracting the current
        latency estimate."""
        seconds = max(seconds, _MIN_SECONDS)
        with self._lock:
            est = self._link(src, dst)
            if nbytes <= _LATENCY_SAMPLE_BYTES:
                a = self.alpha if est.lat_samples else 1.0
                est.latency = (1 - a) * est.latency + a * seconds
                est.lat_samples += 1
            else:
                a = self.alpha if est.bw_samples else 1.0
                payload_s = max(seconds - est.latency, _MIN_SECONDS)
                bw = nbytes / payload_s
                est.bandwidth = (1 - a) * est.bandwidth + a * bw
                est.bw_samples += 1
            est.samples += 1

    # -- queries -------------------------------------------------------
    def bandwidth(self, src: int, dst: int) -> float:
        with self._lock:
            return self._link(src, dst).bandwidth

    def latency(self, src: int, dst: int) -> float:
        with self._lock:
            return self._link(src, dst).latency

    def samples(self, src: int, dst: int) -> int:
        with self._lock:
            est = self._links.get((src, dst))
            return est.samples if est is not None else 0

    def cost_s(self, src: int, dst: int, nbytes: int) -> float:
        """Predicted seconds to move ``nbytes`` over (src → dst) — the
        scheduler's transfer-cost estimate."""
        with self._lock:
            return self._link(src, dst).cost_s(nbytes)

    def chunk_bytes(self, src: int, dst: int, target_s: float,
                    lo: int = 64 << 10, hi: int = 8 << 20) -> int:
        """Pipeline chunk size for (src → dst): the bandwidth-delay
        product at ``target_s`` per chunk, clamped to [lo, hi] so a wild
        estimate can neither devolve into per-byte messages nor disable
        pipelining outright. QUANTIZED to a power of two with hysteresis:
        the EWMA drifts a little on every sample, and an un-quantized (or
        boundary-flapping) size would give messages fresh chunk shapes —
        defeating transfer caches keyed on shapes. The stored choice only moves once the raw
        bandwidth-delay product leaves a ~2.7× band around it."""
        import math
        with self._lock:
            est = self._link(src, dst)
            raw = min(max(est.bandwidth * target_s, lo), hi)
            key = (target_s, lo, hi)
            prev = est.chunk_choice.get(key)
            if prev is not None and prev / 2.66 <= raw <= prev * 2.66:
                return prev
            q = 1 << max(round(math.log2(raw)), 0)  # nearest power of two
            q = min(max(q, lo), hi)
            est.chunk_choice[key] = q
            return q

    def measured(self, src: int, dst: int) -> bool:
        """True once at least one real sample refined (src → dst)."""
        with self._lock:
            est = self._links.get((src, dst))
            return est is not None and est.samples > 0

    def seed_from_path(self, src: int, dst: int, via: int = HOST) -> bool:
        """Seed an UNMEASURED (src → dst) link from the measured two-hop
        path src → via → dst: bandwidth is the path's bottleneck, latency
        the hops' sum (ROADMAP follow-up c — a first estimate better than
        the global default, without probing all pairs at startup). The
        seed does not count as a sample, so the first real transfer still
        replaces it outright. Returns True when a seed was installed."""
        with self._lock:
            est = self._link(src, dst)
            if est.samples > 0:
                return False
            up = self._links.get((src, via))
            down = self._links.get((via, dst))
            if up is None or down is None \
                    or not (up.samples and down.samples):
                return False
            est.bandwidth = min(up.bandwidth, down.bandwidth)
            est.latency = up.latency + down.latency
            return True

    def window_chunks(self, src: int, dst: int, chunk_bytes: int,
                      lo: int = 2, hi: int = 16,
                      queue_depth: Optional[int] = None,
                      slab_bytes: Optional[int] = None) -> int:
        """Credit window for a chunk-streamed (src → dst) transfer.

        Without feedback (``queue_depth``/``slab_bytes`` both None) this
        is the static BDP sizing: how many chunks must be in flight to
        cover the link's bandwidth-delay product (one round-trip of
        credits at the measured bandwidth), plus one so the sender always
        has a chunk ready when a credit returns. Clamped to [lo, hi]: ≥2
        keeps the pipeline sustained even on degenerate estimates, and
        the cap bounds receiver-side landing memory.

        With feedback it is a CONTROLLER (AIMD), stepped on every credit
        the receiver considers — mid-stream, not just at CTS: a
        transfer-lane backlog of ``WINDOW_BACKLOG_DEPTH``+ chunks (or
        landing slabs above ``WINDOW_SLAB_LIMIT`` bytes) halves the
        window, never below 1 — the receiver is the bottleneck, and
        piling more chunks into its queue only grows latency for
        everything sharing the lane; an empty queue (the receiver drains
        ahead of arrival) widens it by one chunk back toward the BDP
        ceiling. The controller state is per directed link, so concurrent
        streams on one link share (and jointly adapt) the window."""
        with self._lock:
            est = self._link(src, dst)
            bdp = est.bandwidth * 2.0 * est.latency
            bdp_win = int(min(max(bdp // max(chunk_bytes, 1) + 1, lo), hi))
            if queue_depth is None and slab_bytes is None:
                return bdp_win
            cur = est.window_choice
            if cur is None:
                cur = bdp_win
            backed_up = (queue_depth or 0) >= WINDOW_BACKLOG_DEPTH \
                or (slab_bytes or 0) > WINDOW_SLAB_LIMIT
            if backed_up:
                cur = max(cur // 2, 1)           # multiplicative decrease
            elif (queue_depth or 0) == 0:
                cur = min(cur + 1, max(bdp_win, 1))   # additive increase
            est.window_choice = cur
            return cur

    def latency_outliers(self, sources, dst: int) -> Dict[int, float]:
        """Per-source EWMA latency toward ``dst``, as a ratio against the
        median across ``sources`` — the straggler-detection signal: a
        frozen/overloaded rank's (fault-delayed) traffic inflates its
        link latency while its peers' stays flat. Unmeasured links ratio
        to 1.0 (no evidence is not evidence of slowness)."""
        with self._lock:
            lats = {}
            for s in sources:
                est = self._links.get((s, dst))
                if est is not None and est.lat_samples > 0:
                    lats[s] = est.latency
        if not lats:
            return {s: 1.0 for s in sources}
        med = sorted(lats.values())[len(lats) // 2]
        med = max(med, _MIN_SECONDS)
        return {s: (lats[s] / med if s in lats else 1.0) for s in sources}

    def current_window(self, src: int, dst: int) -> Optional[int]:
        """The adaptive controller's current (src → dst) window, or None
        when no adaptive decision has been made on that link yet."""
        with self._lock:
            est = self._links.get((src, dst))
            return est.window_choice if est is not None else None

    def reset_window(self, src: int, dst: int) -> None:
        """Forget the adaptive controller state for (src → dst) — the
        next adaptive decision restarts from the BDP sizing (benchmarks
        use this for clean A/B arms; estimates are untouched)."""
        with self._lock:
            est = self._links.get((src, dst))
            if est is not None:
                est.window_choice = None

    # -- collective shape selection (distributed/collectives_rt.py) ----
    def ring_order(self, members: Sequence[int],
                   nbytes: int = 1 << 20) -> List[int]:
        """Topology-aware ring order over ``members`` for chunk-streamed
        collectives: a greedy nearest-neighbor walk over the EWMA link
        table, so each ring hop rides the cheapest still-available link
        out of the current endpoint (predicted ``cost_s`` at ``nbytes``
        per hop — the bandwidth-phase payload size, since ring
        collectives are bandwidth-bound). Deterministic: the walk starts
        at the smallest member id and breaks cost ties by member id, so
        an unmeasured table (all defaults) degrades to sorted order and
        two runs over the same estimates choose the same ring — which is
        what keeps ring-reduction order, and therefore float bits,
        reproducible."""
        members = sorted(set(members))
        if len(members) <= 2:
            return members
        with self._lock:
            def cost(a: int, b: int) -> float:
                est = self._links.get((a, b))
                if est is None:
                    est = LinkEstimate(self._default_bw, self._default_lat)
                return est.cost_s(nbytes)

            order = [members[0]]
            rest = set(members[1:])
            while rest:
                cur = order[-1]
                order.append(min(rest, key=lambda c: (cost(cur, c), c)))
                rest.discard(order[-1])
        return order

    def tree_order(self, root: int, members: Sequence[int],
                   nbytes: int = 4 << 10) -> List[int]:
        """Binomial-tree position order for eager (latency-bound)
        collectives: ``root`` at position 0, remaining members sorted by
        predicted (root → member) link cost at the small-message size,
        ties by member id. Binomial trees put low positions nearest the
        root and give them the most children, so ranks behind the
        fastest links carry the widest fan-out while slow links hang off
        the leaves. Deterministic under equal estimates (sorted order),
        for the same bit-reproducibility reason as ``ring_order``."""
        members = sorted(set(members))
        if root not in members:
            raise ValueError(f"tree root {root} not in members {members}")
        rest = [m for m in members if m != root]
        with self._lock:
            def cost(m: int) -> float:
                est = self._links.get((root, m))
                if est is None:
                    est = LinkEstimate(self._default_bw, self._default_lat)
                return est.cost_s(nbytes)

            rest.sort(key=lambda m: (cost(m), m))
        return [root] + rest

    def penalty_bytes(self, src: int, dst: int, seconds: float,
                      lo: int = 64 << 10, hi: int = 1 << 20) -> int:
        """Byte-equivalent of ``seconds`` of queueing on the (src → dst)
        link — how the gravity placement converts queue pressure into the
        byte space its score lives in (clamped: a degenerate bandwidth
        estimate must not swamp or erase real residency)."""
        with self._lock:
            bw = self._link(src, dst).bandwidth
        return int(min(max(bw * seconds, lo), hi))

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Stats view: ``{"src->dst": {bw_MBps, lat_us, samples}}``."""
        with self._lock:
            return {
                f"{src}->{dst}": {
                    "bw_MBps": round(e.bandwidth / 1e6, 3),
                    "lat_us": round(e.latency * 1e6, 3),
                    "samples": e.samples,
                }
                for (src, dst), e in sorted(self._links.items())
            }


def probe_link(src_dev, dst_dev, model: InterconnectModel,
               nbytes: int = 64 << 10) -> None:
    """Lazy first-use micro-probe of one device pair (ROADMAP follow-up
    c): the startup probe covers host→device plus a device ring in O(n);
    any pair it skipped gets ONE timed ``nbytes`` transfer here, the
    moment the runtime first moves real data across it. The staging
    upload onto the source device is not timed — only the src→dst hop
    under measurement is."""
    import time

    import numpy as np

    payload = np.ones(max(nbytes // 4, 1), np.float32)
    staged = src_dev.synchronize(src_dev.upload(payload))
    t0 = time.perf_counter()
    dst_dev.synchronize(dst_dev.transfer_from(src_dev, staged))
    model.observe(src_dev.info.device_id, dst_dev.info.device_id,
                  payload.nbytes, time.perf_counter() - t0)


def probe_runtime_links(model: InterconnectModel, devices,
                        nbytes: int = 64 << 10) -> None:
    """Cheap startup micro-probe: one ``nbytes`` upload per device (host →
    device) and one ring hop per adjacent device pair (device → device,
    both directions), each timed and folded into ``model``. Ring, not
    all-pairs: the probe must stay O(n) so runtimes with many devices
    start fast; online refinement fills in the rest."""
    import time

    import numpy as np

    from repro_torch.core.hetero_object import HOST

    payload = np.ones(max(nbytes // 4, 1), np.float32)
    staged = {}
    for dev in devices:
        t0 = time.perf_counter()
        arr = dev.synchronize(dev.upload(payload))
        model.observe(HOST, dev.info.device_id, payload.nbytes,
                      time.perf_counter() - t0)
        staged[dev.info.device_id] = arr
    n = len(devices)
    seen = set()
    for i in range(n if n > 1 else 0):
        src, dst = devices[i], devices[(i + 1) % n]
        for a, b in ((src, dst), (dst, src)):
            if (a.info.device_id, b.info.device_id) in seen:
                continue
            seen.add((a.info.device_id, b.info.device_id))
            t0 = time.perf_counter()
            b.synchronize(b.transfer_from(a, staged[a.info.device_id]))
            model.observe(a.info.device_id, b.info.device_id,
                          payload.nbytes, time.perf_counter() - t0)
