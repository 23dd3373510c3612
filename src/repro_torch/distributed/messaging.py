"""Message-driven distributed runtime (PREMA layer, paper §3.2;
``repro/distributed/messaging.py`` at the same path).

Faithful reproduction of the messaging semantics on an in-process "cluster":
each rank runs a message-pump thread with its own heterogeneous tasking
Runtime, and inter-rank messages follow the paper's two-phase protocol —

  sender:   (1) async read-access request on the hetero_object
            (2) push {future, metadata} to the outgoing pending queue
            (3) pump polls the queue
            (4) when the future completes, send metadata msg + payload msg
            (5) release access
  receiver: (1) receive metadata  (2) prepare buffer  (3) receive payload
            (4) request device allocation  (5) run the user handler

Two payload paths are modeled, matching §3.2.3: HOST_STAGED (device→host →
network → host→device) and DIRECT (device→device; "GPU-aware interconnect").
The DIRECT path is real, not simulated: the sender snapshots the freshest
*device* copy via ``Runtime._request_device_view`` (a private on-device
clone: tensors are mutable, so a later in-place writer of the object must
not reach a message in flight), the payload travels as that device tensor,
and the receiver lands it with one Device API ``transfer`` onto its own
device — no host copy is materialized on either side. Per-path traffic is accounted
in ``Rank.stats`` (``bytes_d2d`` vs ``bytes_staged``).

Protocol split (paper §4.2.2–§4.2.3): payloads at or below
``RuntimeConfig.eager_threshold`` travel EAGERLY — one metadata message
plus one monolithic payload message, with ≤512B payloads inlined in the
metadata. Larger payloads (including oversized ``Rank.put`` bodies)
switch to a RENDEZVOUS protocol: the sender announces the message (RTS),
the receiver prepares a consumer-routed landing device and replies ready
(CTS) carrying an initial CREDIT WINDOW sized from the link's measured
bandwidth-delay product, and the sender streams the payload in chunks
sized from the same measurements (``Cluster.topology``, refined from
every delivery).

Progress is completion-driven, never blocking (paper §5–6: control
messages stay cheap while payloads stream). All sender-side streaming
runs on the rank's ``net-send`` progress-engine lane — the message pump
only parks payloads and forwards credits, so a large stream never
head-of-line blocks unrelated messages. The credit window keeps ≥2
chunks in flight per stream: each chunk the receiver finishes uploading
returns one credit, and the sender's lane advances the stream the moment
a credit arrives instead of waiting for the whole previous chunk's
round trip. Arriving chunks are handed straight to the landing device's
transfer lane (receive of chunk k+1 overlaps the upload of chunk k), and
stream completion — waiting out the tail uploads and invoking the
handler — runs on the rank's ``net-recv`` lane, off the pump.
Host-staged chunks travel through pooled staging buffers that return to
the sender's pool once the receiver's upload completes (the RDMA
buffer-recycle analogue). ``Rank.stats`` records ``eager``/``rendezvous``
message counts, ``chunks_out``/``chunks_in``, ``max_window`` (most
chunks ever in flight in one stream) and ``overlap_bytes`` — chunk
uploads that had fully completed before the last chunk arrived, i.e.
copies hidden entirely behind the network.

Flow control is ADAPTIVE and receiver-paced (unless ``net_window`` pins
it): every credit decision consults ``InterconnectModel.window_chunks``
as an AIMD controller fed with the receiver's live transfer-lane backlog
and landing-slab occupancy — both of which also travel back to the
sender in the credit message, alongside the receiver's cumulative
completed-upload count (``acked``) and the new window target. When the
receiver's lane backs up the controller halves the window (min 1) and
the receiver *withholds* credits (``credits_deferred``); when the lane
drains ahead of arrival it widens back toward the BDP ceiling and grants
the accumulated credits in one coalesced message (fewer control messages
than naive per-chunk crediting — which matters, because the simulated
control channel has a finite drain rate and bills credit chatter). The
sender honors shrink directly: ``_advance_stream`` holds chunks — even
with banked credits — while ``sent − acked`` is at or above the
receiver's latest window.

A multi-chunk stream lands in a flat slab on the landing device: the slab
is allocated on that device's transfer stream at the RTS, and each chunk is
written into it in place (``slab[off:off + n].copy_(chunk)``, or ``.add_``
for a reduce stream) on the same stream, so the per-chunk device cost is
chunk-sized.

This layer is the host-side control plane and the single-node
multi-device execution engine; ranks are threads of one process.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import queue
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.convert import numpy_dtype, to_numpy, torch_dtype
from repro_torch.core import HeteroObject, Runtime, RuntimeConfig
from repro_torch.core import clock, sanitizer
from repro_torch.core.device_api import TorchDevice
from repro_torch.core.device_api import transfer as d2d_transfer
from repro_torch.core.futures import HFuture
from repro_torch.core.hetero_object import HOST
from repro_torch.core.integrity import digest_array
from repro_torch.core.progress import ProgressEngine
from repro_torch.core.topology import InterconnectModel
from repro_torch.distributed import handlers as H

INLINE_PAYLOAD_BYTES = 512
# rendezvous chunk-size clamp: the bandwidth-delay product drives the
# size, but a degenerate estimate must not collapse to per-byte messages
# or a single unpipelined chunk
MIN_CHUNK_BYTES = 64 << 10
MAX_CHUNK_BYTES = 4 << 20
_msg_ids = itertools.count()
_FLUSH = object()            # pump wake-up sentinel (not a Message)

# message classes (shared by the simulated wire's virtual channels and
# the receive-side inbox ordering): control traffic never waits behind
# payloads, eager payloads never wait behind a streamed bulk window
PRIO_CONTROL = 0
PRIO_EAGER = 1
PRIO_BULK = 2
_CONTROL_KINDS = frozenset({"cts", "ack", "credit", "get", "nack"})
# bounded memory for the reliability layer's duplicate-suppression set
_SEEN_CAP = 2048


def msg_priority(msg: "Message", nbytes: int) -> int:
    # a metadata message with its payload inlined (≤ INLINE_PAYLOAD_BYTES)
    # is control-sized — it rides the control VC the way real fabrics
    # send sub-MTU inline messages (paper §4.2.3 small-message path)
    if nbytes == 0 or msg.inline is not None \
            or msg.kind in _CONTROL_KINDS:
        return PRIO_CONTROL
    return PRIO_BULK if msg.kind == "chunk" else PRIO_EAGER


def _host(x: Any) -> np.ndarray:
    """A payload or landed part as a host array (a device tensor is
    downloaded)."""
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _slab_write(device: TorchDevice, slab: torch.Tensor, chunk: Any,
                off: int, reduce: bool) -> None:
    """Write (or, for a reduce stream, add) ``chunk`` into the landing
    slab at element offset ``off``, in place, on the landing device's
    transfer stream, and wait for it: the caller's chunk (a view of the
    sender's pooled staging buffer, or of its private device snapshot)
    may be recycled as soon as this returns. The per-chunk cost is
    chunk-sized."""
    src = chunk if isinstance(chunk, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(chunk))
    window = slab[off:off + src.numel()]
    with _on_transfer_stream(device):
        if reduce:
            window.add_(src.to(slab.device, non_blocking=True))
        else:
            window.copy_(src, non_blocking=True)
    if device.is_cuda:
        device._record(device.transfer_stream).synchronize()


def _on_transfer_stream(device: TorchDevice):
    """The landing device's transfer stream as the current stream (a CPU
    device has none)."""
    return device._on(device.transfer_stream) if device.is_cuda \
        else contextlib.nullcontext()


@dataclasses.dataclass
class Message:
    msg_id: int
    # 'meta' | 'payload' | 'cts' | 'chunk' | 'credit' | 'put' | 'get'
    # | 'ack'
    kind: str
    src: int
    dst: int
    handler: Optional[str] = None
    payload_shape: Optional[Tuple[int, ...]] = None
    payload_dtype: Optional[torch.dtype] = None
    inline: Optional[bytes] = None
    payload: Optional[np.ndarray] = None     # "network" buffer
    object_key: Optional[Any] = None
    reply_to: Optional[int] = None
    user: Optional[Dict[str, Any]] = None
    path: str = "host"         # 'host' (staged) | 'direct'
    # receiver device the payload's consumer task will run on, when the
    # sender knows it (consumer-routed delivery, ROADMAP follow-up d)
    consumer_device: Optional[int] = None
    # -- rendezvous protocol fields --
    protocol: str = "eager"    # 'eager' | 'rdzv'
    op: str = "send"           # what a rendezvous stream completes into:
    #                            'send' (handler invocation) | 'put'
    #                            (overwrite the keyed target object) |
    #                            'reduce' (accumulate INTO the keyed
    #                            target: chunks add into the landing slab
    #                            instead of rebinding it — collectives)
    seq: Optional[int] = None  # chunk index within a rendezvous stream
    offset: Optional[int] = None   # chunk start, in elements
    nchunks: Optional[int] = None
    total_bytes: Optional[int] = None
    # credit-based flow control: the CTS carries the initial window (how
    # many chunks may be in flight); each 'credit' message returns one or
    # more (the receiver coalesces grants when it re-widens the window)
    credits: int = 0
    # -- adaptive flow-control feedback (receiver → sender) --
    # the receiver's current window target; the sender holds chunks while
    # sent − acked ≥ window even if it has banked credits (honors shrink)
    window: Optional[int] = None
    # cumulative chunk uploads the receiver has completed for this stream
    # (keeps the sender's in-flight accounting exact across deferrals)
    acked: int = 0
    # the receiver's transfer-lane backlog and landing-slab occupancy at
    # grant time — the congestion signals the controller fed on
    rx_queue: int = 0
    rx_slab_bytes: int = 0
    # -- reliability layer (engaged by Cluster.fault_injector) --
    # the receiver must acknowledge delivery; the sender retransmits with
    # backoff until the ack arrives or the retry budget is spent
    ack_req: bool = False
    # 'nack' only: chunk seqs the receiver is still missing mid-stream
    missing: Optional[Tuple[int, ...]] = None
    # -- end-to-end integrity --
    # content digest of the payload/inline/chunk bytes, computed once at
    # serialization (host-visible bytes only; DIRECT device payloads are
    # private in-process snapshots and carry None). Verified on every
    # receive under cfg.verify_payloads: a mismatch is treated as
    # never-arrived and the reliability layer retransmits.
    digest: Optional[int] = None


class Rank:
    """One simulated process: message pump + local tasking runtime."""

    def __init__(self, cluster: "Cluster", rank: int,
                 rt_config: Optional[RuntimeConfig] = None):
        self.cluster = cluster
        self.rank = rank
        self.runtime = Runtime(rt_config or RuntimeConfig())
        # priority inbox (receive-side virtual channels): control
        # messages outrank eager payloads outrank bulk chunks, so a
        # small message is never stuck behind a streamed window that
        # already landed in the inbox; FIFO within a class
        self.inbox: "queue.PriorityQueue" = queue.PriorityQueue()
        self._inbox_seq = itertools.count()
        self.outgoing: List[Tuple[HFuture, Message, HeteroObject]] = []
        self._out_lock = sanitizer.make_lock("Rank._out_lock")
        self._pending_meta: Dict[int, Message] = {}
        # rendezvous bookkeeping: outgoing stream state (parked payload,
        # window credits, send cursor) per msg_id — mutated ONLY on the
        # net-send lane after the RTS — in-progress incoming reassembly
        # state per msg_id, and streamed pool buffers awaiting the
        # receiver's completion ack (keyed with the peer they are parked
        # for, so a peer-removal sweep can release exactly its buffers)
        self._rdzv_out: Dict[int, Dict[str, Any]] = {}
        self._rdzv_in: Dict[int, Dict[str, Any]] = {}
        self._rdzv_bufs: Dict[int, Tuple[int, np.ndarray]] = {}
        # -- reliability layer (off unless Cluster.fault_injector engaged
        # it): unacked reliable sends awaiting receiver acks, fully
        # transmitted rendezvous streams awaiting their completion ack
        # (kept resendable for NACK recovery), and the bounded
        # duplicate-suppression set of completed deliveries
        self._reliability = False
        self._unacked: Dict[int, Dict[str, Any]] = {}
        self._unacked_lock = sanitizer.make_lock("Rank._unacked_lock")
        self._rdzv_sent: Dict[int, Dict[str, Any]] = {}
        self._seen: Set[int] = set()
        self._seen_order: "collections.deque[int]" = collections.deque()
        # heartbeat emission (enable_heartbeat): monitor rank + cadence
        self._hb_dst: Optional[int] = None
        self._hb_every = 0.0
        self._hb_next = 0.0
        self._tick_next = 0.0
        # typed progress-engine lanes on the runtime's shared reactor:
        # net-send streams rendezvous chunks (the pump never transmits a
        # payload window itself), net-recv completes incoming streams
        # (tail-upload waits + handler invocation, off the pump)
        self._net_send = self.runtime.engine.lane("net-send", rank)
        self._net_recv = self.runtime.engine.lane("net-recv", rank)
        # >0 while any thread is mid-flush or mid-handler: work extracted
        # from the queues but not yet re-registered anywhere the barrier
        # can see (closes the idle-looking window between popping a
        # message/send and its effects landing). A COUNTER, not a flag:
        # eager sends flush inline on the caller thread, concurrently
        # with the pump's own flush/handle cycle.
        self._active = 0
        self._active_lock = sanitizer.make_lock("Rank._active_lock")
        self.objects: Dict[Any, HeteroObject] = {}   # global ptr -> object
        # handler name -> local device id: where this rank wants payloads
        # for that handler landed (consumer routing, set via route_to)
        self.routes: Dict[str, int] = {}
        self.stats = {"sent": 0, "received": 0, "bytes_out": 0,
                      "bytes_d2d": 0, "bytes_staged": 0,
                      # small host-path payloads upgraded to DIRECT
                      # because a device replica existed (ROADMAP 5a)
                      "direct_upgrades": 0,
                      "eager": 0, "rendezvous": 0,
                      "chunks_out": 0, "chunks_in": 0, "overlap_bytes": 0,
                      "credits_in": 0, "max_window": 0,
                      # adaptive flow control (receiver side): window
                      # retargets, credits withheld under backlog, the
                      # smallest window granted, and the deepest
                      # transfer-lane backlog seen at a credit decision
                      "window_adjusts": 0, "credits_deferred": 0,
                      "window_min": 0, "rx_queue_peak": 0,
                      # pump handler exceptions routed to the error sink
                      "handler_errors": 0,
                      # -- fault tolerance / elasticity --
                      # reliability-layer retransmissions, duplicates
                      # suppressed, sends abandoned after the retry
                      # budget, heartbeats emitted; the elastic layer
                      # fills in missed beats, chunks landed here by
                      # migration, and the cumulative recovery stall
                      "retries": 0, "dup_dropped": 0, "send_failures": 0,
                      "heartbeats_out": 0, "heartbeats_missed": 0,
                      "chunks_migrated": 0, "recovery_stall_s": 0.0,
                      # -- end-to-end integrity --
                      # payload/inline/chunk digest mismatches detected
                      # (each treated as never-arrived → retransmitted),
                      # and the subset that were rendezvous chunks
                      "checksum_fail": 0, "chunks_rejected": 0,
                      # -- runtime collectives (collectives_rt) --
                      # bytes folded into accumulators on this rank
                      # (eager adds + fused reduce-stream chunks), the
                      # deepest op='reduce' chunk pipeline observed, and
                      # collectives aborted here by an epoch bump
                      "coll_bytes_reduced": 0,
                      "coll_chunks_in_flight_peak": 0,
                      "coll_aborts": 0}
        # bounded trace of swallowed pump-handler errors (strict mode
        # re-raises the first at the next Cluster.barrier)
        self._errors: List[BaseException] = []
        self._stop = False
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name=f"prema-rank{rank}")
        self._thread.start()

    # ------------------------------------------------------------------
    # public API (paper: mp_send with hetero_object argument)
    # ------------------------------------------------------------------
    def _device_resident_small(self, obj: HeteroObject) -> bool:
        """ROADMAP 5a upgrade predicate: the payload is small enough for
        the eager path AND a device replica exists — or is about to, via
        a pending writer whose output lands on a device (``last_writer``
        is cleared on task completion, so non-None means in flight)."""
        if obj.nbytes > self.runtime.cfg.eager_threshold:
            return False
        if self.runtime.residency.devices_of(obj):
            return True
        return obj.last_writer is not None

    def send(self, dst: int, handler_name: str, obj: Optional[HeteroObject]
             = None, user: Optional[Dict[str, Any]] = None,
             path: str = "host",
             consumer_device: Optional[int] = None) -> HFuture:
        """One-sided async handler invocation with optional hetero_object
        payload. ``consumer_device`` names the receiver device the payload's
        consumer task will run on, when known — DIRECT payloads then land
        there with a single transfer. Returns a future completed when the
        message has been handed to the network (not when the handler ran)."""
        fut = HFuture()
        meta = Message(msg_id=next(_msg_ids), kind="meta", src=self.rank,
                       dst=dst, handler=handler_name, user=user, path=path,
                       consumer_device=consumer_device)
        if obj is None:
            if self._reliability:
                meta.ack_req = True
                self._track_unacked([meta])
            self.cluster.deliver(meta)
            self.stats["sent"] += 1
            fut.set_result(None)
            return fut
        meta.payload_shape = tuple(obj.shape)
        meta.payload_dtype = torch_dtype(obj.dtype)
        # ROADMAP 5a: small payloads with a live (or pending) device replica
        # skip the host bounce — upgrade to the DIRECT device-view path.
        # Stale residency is harmless: a HOST-only view at flush time
        # degrades the message back to host staging.
        if path == "host" and self._device_resident_small(obj):
            path = meta.path = "direct"
            self.stats["direct_upgrades"] += 1
        # (1) async access request; payload follows when ready. DIRECT sends
        # take a device view (no host staging, §3.2.3 Fig. 7); host-staged
        # sends pin a host copy as before (Fig. 6).
        if path == "direct":
            access = self.runtime._request_device_view(obj)
        else:
            access = obj.request_host(write=False)

        def on_ready(_):
            with self._out_lock:
                self.outgoing.append((access, meta, obj))
            # flush inline: when the payload is already available (the
            # common fast path) the message reaches the network on THIS
            # thread — no pump wake-up on the latency path. Safe from any
            # thread: extraction is serialized by _out_lock and in-flight
            # work is accounted by the _active counter.
            self._flush_outgoing()
            fut.set_result(None)

        access.add_done_callback(on_ready)
        return fut

    def put(self, dst: int, object_key: Any, data: HeteroObject,
            on_done: Optional[str] = None, path: str = "host",
            consumer_device: Optional[int] = None,
            user: Optional[Dict[str, Any]] = None) -> HFuture:
        """Remote put: overwrite the target's hetero_object (paper §4.2.4:
        reuses existing, pinned target memory — no receiver allocation).
        ``path='direct'`` ships the freshest device copy with no host
        staging on either side (consumer-routed: the payload lands on
        ``consumer_device``, else a device already holding the target).
        Payloads above the eager threshold chunk-stream through the same
        credit-windowed rendezvous path as large sends (ROADMAP follow-up
        b) — the stream completes into the target object instead of a
        handler allocation. ``user`` rides to the ``on_done`` handler's
        context (the collectives engine threads hop metadata through it)."""
        return self._put_like(dst, object_key, data, "put", on_done, path,
                              consumer_device, user)

    def reduce_into(self, dst: int, object_key: Any, data: HeteroObject,
                    on_done: Optional[str] = None, path: str = "host",
                    consumer_device: Optional[int] = None,
                    user: Optional[Dict[str, Any]] = None) -> HFuture:
        """Remote accumulate: add this rank's ``data`` INTO the target's
        keyed hetero_object instead of overwriting it — the collective
        stream variant of ``put`` (what runtime collectives build on). Large
        payloads ride the same credit-windowed rendezvous path, but the
        receiver initializes the landing slab from the target's current
        value and every chunk is a fused chunk-sized add on the landing
        device's transfer lane (``_slab_write``), so chunk k+1's
        network receive overlaps chunk k's reduction; the finished slab
        rebinds as the target's only valid copy. Small payloads add on
        the receiver's host copy. The in-flight chunk window is capped by
        ``RuntimeConfig.coll_max_inflight_chunks`` on top of the AIMD
        controller. A ``reduce_into`` against an unregistered key is
        dropped on the receiver (aborted collective): the stream still
        completes and acks, nothing is mutated."""
        return self._put_like(dst, object_key, data, "reduce", on_done,
                              path, consumer_device, user)

    def _put_like(self, dst: int, object_key: Any, data: HeteroObject,
                  op: str, on_done: Optional[str], path: str,
                  consumer_device: Optional[int],
                  user: Optional[Dict[str, Any]]) -> HFuture:
        fut = HFuture()
        if path == "host" and self._device_resident_small(data):
            path = "direct"          # ROADMAP 5a, same upgrade as send()
            self.stats["direct_upgrades"] += 1
        if path == "direct":
            access = self.runtime._request_device_view(data)
        else:
            access = data.request_host(write=False)

        def on_ready(_):
            used_path = path
            pooled = False
            thr = self.runtime.cfg.eager_threshold
            if path == "direct":
                space, arr = access.get()
                if space == HOST:          # no device copy: degrade
                    used_path = "host"
            else:
                src = np.asarray(access.get())
                if src.nbytes > thr and self.runtime.staging.enabled:
                    arr = self.runtime.staging.acquire(src.shape, src.dtype)
                    np.copyto(arr, src)
                    pooled = True
                else:
                    arr = np.array(src)
                data.release()
            key = "bytes_d2d" if used_path == "direct" else "bytes_staged"
            self.stats[key] += arr.nbytes
            if arr.nbytes > thr:
                meta = Message(msg_id=next(_msg_ids), kind="meta",
                               src=self.rank, dst=dst, op=op,
                               object_key=object_key, handler=on_done,
                               path=used_path, user=user,
                               consumer_device=consumer_device,
                               payload_shape=tuple(arr.shape),
                               payload_dtype=torch_dtype(arr.dtype))
                self._start_rendezvous(meta, arr, arr.nbytes, pooled)
                fut.set_result(None)
                return
            msg = Message(msg_id=next(_msg_ids), kind="put", src=self.rank,
                          dst=dst, op=op, object_key=object_key,
                          payload=arr, handler=on_done, path=used_path,
                          user=user, consumer_device=consumer_device,
                          digest=self._digest_for(arr))
            if self._reliability:
                msg.ack_req = True
                self._track_unacked([msg])
            self.cluster.deliver(msg)
            self.stats["sent"] += 1
            self.stats["bytes_out"] += arr.nbytes
            fut.set_result(None)

        access.add_done_callback(on_ready)
        return fut

    def get(self, dst: int, object_key: Any, handler_name: str,
            path: str = "host",
            consumer_device: Optional[int] = None) -> HFuture:
        """Remote get: ask ``dst`` for object data; handler runs locally
        with the received hetero_object. ``path``/``consumer_device``
        shape the REPLY: a direct reply travels device-to-device and
        lands consumer-routed on this rank (large replies chunk-stream
        through the rendezvous protocol like any other send)."""
        fut = HFuture()
        msg = Message(msg_id=next(_msg_ids), kind="get", src=self.rank,
                      dst=dst, object_key=object_key, handler=handler_name,
                      path=path, consumer_device=consumer_device)
        self.cluster.deliver(msg)
        self.stats["sent"] += 1
        fut.set_result(None)
        return fut

    def register_object(self, key: Any, obj: HeteroObject) -> None:
        self.objects[key] = obj

    def route_to(self, handler_name: str, device_id: int) -> None:
        """Declare that payloads for ``handler_name`` will be consumed by
        tasks on local ``device_id`` — incoming DIRECT payloads land there
        directly instead of on the least-loaded fallback."""
        self.routes[handler_name] = device_id

    def enable_heartbeat(self, monitor: int,
                         interval_s: Optional[float] = None) -> None:
        """Emit a 0-byte ``elastic_heartbeat`` control message to rank
        ``monitor`` every ``interval_s`` (default
        ``RuntimeConfig.heartbeat_interval_s``) from the pump loop. The
        heartbeat rides the billed control VC like any other control
        message — liveness signalling is not free on a congested link,
        which is exactly why the elastic layer also reads latency/backlog
        telemetry instead of trusting heartbeat timing alone."""
        self._hb_every = interval_s if interval_s is not None \
            else self.runtime.cfg.heartbeat_interval_s
        self._hb_dst = monitor
        self._hb_next = 0.0

    # -- end-to-end integrity (content digests at every boundary) ------
    def _digest_for(self, data: Any) -> Optional[int]:
        """Sender-side content digest, computed ONCE at serialization for
        host-visible bytes (np payloads, inline bytes, chunk views).
        DIRECT device payloads carry None: they cross the in-process
        'wire' as private device snapshots — there are no wire bytes to
        flip, and hashing them would force a device→host readback on the
        zero-copy path."""
        if not self.runtime.cfg.verify_payloads:
            return None
        if isinstance(data, (np.ndarray, bytes, bytearray, memoryview)):
            return digest_array(data)
        return None

    def _verify(self, msg: Message, data: Any) -> bool:
        """Receiver-side digest check. False means the bytes are to be
        treated as NEVER-ARRIVED — the caller drops them without acking
        or recording progress, and the reliability layer's retransmission
        (or the stalled-stream NACK) brings the clean bytes back, so
        corruption surfaces as a retry, never a hang or a wrong answer."""
        if msg.digest is None or not self.runtime.cfg.verify_payloads:
            return True
        if digest_array(data) == msg.digest:
            return True
        self.stats["checksum_fail"] += 1
        return False

    # -- reliability layer (retry / ack / nack; fault-injection mode) ---
    def _track_unacked(self, msgs: List[Message]) -> None:
        """Register a reliable send: ``msgs`` (a meta and its optional
        payload half) are retransmitted together on a backoff schedule
        until the receiver's delivery ack clears them."""
        m0 = msgs[0]
        with self._unacked_lock:
            self._unacked[m0.msg_id] = {
                "msgs": list(msgs), "dst": m0.dst, "attempts": 0,
                "deadline": time.perf_counter()
                + self.runtime.cfg.retry_backoff_s}

    def _ack_unacked(self, msg_id: int) -> None:
        with self._unacked_lock:
            self._unacked.pop(msg_id, None)

    def _mark_done(self, msg: Message, ack: bool = True) -> None:
        """Delivery completed under the reliability layer: remember the
        msg_id (bounded) so a straggling retransmission is suppressed as
        a duplicate, and ack the sender when it asked."""
        if not self._reliability:
            return
        if msg.msg_id not in self._seen:
            self._seen.add(msg.msg_id)
            self._seen_order.append(msg.msg_id)
            while len(self._seen_order) > _SEEN_CAP:
                self._seen.discard(self._seen_order.popleft())
        if ack and msg.ack_req:
            self.cluster.deliver(Message(msg_id=msg.msg_id, kind="ack",
                                         src=self.rank, dst=msg.src))

    def _tick(self) -> None:
        """Pump-loop housekeeping (throttled to ``retry_tick_s``): emit
        the periodic heartbeat, retransmit overdue unacked sends and
        rendezvous tails, and NACK incoming streams that stalled."""
        now = time.perf_counter()
        if now < self._tick_next:
            return
        self._tick_next = now + self.runtime.cfg.retry_tick_s
        if self._hb_dst is not None and now >= self._hb_next:
            self._hb_next = now + self._hb_every
            self.stats["heartbeats_out"] += 1
            self.cluster.deliver(Message(
                msg_id=next(_msg_ids), kind="meta", src=self.rank,
                dst=self._hb_dst, handler="elastic_heartbeat",
                user={"worker": self.rank}))
        if self._reliability:
            self._retry_unacked(now)
            self._retry_tails(now)
            self._nack_stalled_streams(now)

    def _retry_unacked(self, now: float) -> None:
        """Retransmit reliable sends whose ack is overdue, with
        exponential backoff; a send that exhausts ``send_retries`` is
        abandoned and counted in ``send_failures`` (the elastic layer —
        not the transport — decides what a persistent failure means)."""
        cfg = self.runtime.cfg
        with self._unacked_lock:
            items = list(self._unacked.items())
        gone = []
        for mid, st in items:
            if now < st["deadline"]:
                continue
            st["attempts"] += 1
            if st["attempts"] > cfg.send_retries:
                gone.append(mid)
                self.stats["send_failures"] += 1
                continue
            st["deadline"] = now + cfg.retry_backoff_s \
                * (cfg.retry_backoff_mult ** st["attempts"])
            self.stats["retries"] += 1
            for m in st["msgs"]:
                self.cluster.deliver(m)
        if gone:
            with self._unacked_lock:
                for mid in gone:
                    self._unacked.pop(mid, None)

    def _retry_tails(self, now: float) -> None:
        """A fully transmitted rendezvous stream whose completion ack is
        overdue gets its LAST chunk resent: if the tail chunk was lost
        the receiver can now finish; if only the ack was lost the
        receiver re-acks the orphan chunk (``_receive_chunk``), releasing
        the parked pool buffer either way."""
        cfg = self.runtime.cfg
        for mid, st in list(self._rdzv_sent.items()):
            if now < st["deadline"]:
                continue
            st["attempts"] += 1
            if st["attempts"] > cfg.send_retries:
                self._rdzv_sent.pop(mid, None)
                parked = self._rdzv_bufs.pop(mid, None)
                if parked is not None:
                    self.runtime.staging.release(parked[1])
                self.stats["send_failures"] += 1
                continue
            st["deadline"] = now + cfg.retry_backoff_s \
                * (cfg.retry_backoff_mult ** st["attempts"])
            meta, flat, elems = st["meta"], st["flat"], st["elems"]
            k = meta.nchunks - 1
            self.stats["retries"] += 1
            piece = flat[k * elems:(k + 1) * elems]
            self.cluster.deliver(Message(
                msg_id=mid, kind="chunk", src=self.rank, dst=meta.dst,
                seq=k, offset=k * elems, nchunks=meta.nchunks,
                payload=piece, path=meta.path,
                digest=self._digest_for(piece)))

    def _nack_stalled_streams(self, now: float) -> None:
        """Receiver-side loss recovery: an incomplete incoming stream
        that made no progress for a backoff interval gets a NACK naming
        the missing chunk seqs (capped) — the sender resends exactly
        those. A stream that stays dry past the retry budget is swept
        (the peer-loss path will also reap it)."""
        cfg = self.runtime.cfg
        for mid, st in list(self._rdzv_in.items()):
            meta = st["meta"]
            if st["arrived"] >= meta.nchunks:
                continue
            nacks = st.get("nacks", 0)
            backoff = cfg.retry_backoff_s * (cfg.retry_backoff_mult ** nacks)
            if now - st.get("last_progress", now) < backoff:
                continue
            st["nacks"] = nacks + 1
            st["last_progress"] = now
            if st["nacks"] > cfg.send_retries:
                self._rdzv_in.pop(mid, None)
                self.stats["send_failures"] += 1
                continue
            have = st["uploads"]
            missing = tuple(k for k in range(meta.nchunks)
                            if k not in have)[:64]
            if not missing:
                continue
            self.cluster.deliver(Message(
                msg_id=mid, kind="nack", src=self.rank, dst=meta.src,
                credits=len(missing), window=st["win"],
                acked=st["completed"], missing=missing))

    def _handle_nack(self, msg: Message) -> None:
        """Net-send lane only: the receiver is missing chunks. Already
        transmitted seqs are resent from the parked payload (live stream
        or awaiting-ack tail); never transmitted seqs mean the credits
        were lost — fold the NACK in as a credit grant so the stream
        moves again."""
        st = self._rdzv_out.get(msg.msg_id)
        flat = elems = meta = None
        if st is not None:
            meta, flat, elems = st["meta"], st["flat"], st["elems"]
            cutoff = st["next_seq"]
        else:
            sent = self._rdzv_sent.get(msg.msg_id)
            if sent is None:
                return
            meta, flat, elems = sent["meta"], sent["flat"], sent["elems"]
            cutoff = meta.nchunks
        fresh = 0
        for k in (msg.missing or ()):
            if k >= cutoff:
                fresh += 1
                continue
            self.stats["retries"] += 1
            self.stats["chunks_out"] += 1
            piece = flat[k * elems:(k + 1) * elems]
            self.cluster.deliver(Message(
                msg_id=msg.msg_id, kind="chunk", src=self.rank,
                dst=meta.dst, seq=k, offset=k * elems,
                nchunks=meta.nchunks, payload=piece, path=meta.path,
                digest=self._digest_for(piece)))
        if fresh and st is not None:
            self._advance_stream(msg.msg_id, fresh, window=msg.window,
                                 acked=msg.acked)

    def enqueue(self, item: Any, priority: int = PRIO_CONTROL) -> None:
        """Post a message (or pump sentinel) to this rank's inbox at the
        given virtual-channel priority; FIFO within a priority class."""
        self.inbox.put((priority, next(self._inbox_seq), item))

    def dispatch_control(self, msg: Message) -> bool:
        """Network-layer fast dispatch: stream-advance control messages
        (CTS, credits) post their job straight onto the net-send lane
        that consumes them, skipping the pump hop entirely — one fewer
        thread wake in the per-chunk credit loop, which is the loop's
        critical path. Returns True when the message was consumed."""
        if msg.kind == "cts" or msg.kind == "credit":
            if msg.kind == "cts":
                self._ack_unacked(msg.msg_id)   # RTS confirmed received
            if self._stop:
                return True        # rank leaving: drop stream advances
            try:
                self._net_send.submit(
                    lambda mid=msg.msg_id, c=msg.credits, w=msg.window,
                    a=msg.acked, init=(msg.kind == "cts"):
                    self._advance_stream(mid, c, window=w, acked=a,
                                         initial=init))
            except RuntimeError:   # lane stopped mid-shutdown: drop
                pass
            return True
        if msg.kind == "nack":
            if self._stop:
                return True
            try:
                self._net_send.submit(lambda m=msg: self._handle_nack(m))
            except RuntimeError:
                pass
            return True
        return False

    # ------------------------------------------------------------------
    # pump
    # ------------------------------------------------------------------
    def _busy_enter(self) -> None:
        with self._active_lock:
            self._active += 1

    def _busy_exit(self) -> None:
        with self._active_lock:
            self._active -= 1

    def _flush_outgoing(self):
        ready = []
        with self._out_lock:
            still = []
            for access, meta, obj in self.outgoing:
                if access.done():
                    if not ready:
                        self._busy_enter()   # visible before outgoing shrinks
                    ready.append((access, meta, obj))
                else:
                    still.append((access, meta, obj))
            self.outgoing = still
        if not ready:
            return
        try:
            self._flush_ready(ready)
        finally:
            self._busy_exit()

    def _flush_ready(self, ready) -> None:
        for access, meta, obj in ready:
            pooled = False
            if meta.path == "direct":
                # device-aware interconnect (§3.2.3 Fig. 7): the NIC reads
                # device memory directly — the payload stays a device array
                space, arr = access.get()   # arr: private on-device clone
                if space == HOST:
                    # no device copy existed; fall back to the staged path
                    # (arr is already a private host copy)
                    meta.path = "host"
            else:
                # host-staged (§3.2.3 Fig. 6): ONE staging copy. A payload
                # bound for the rendezvous protocol stages into a pooled
                # buffer — chunks are zero-copy windows into it (the NIC
                # reads the pinned buffer directly), and the buffer
                # returns to the pool on the receiver's completion ack
                src = np.asarray(access.get())
                rdzv = src.nbytes > self.runtime.cfg.eager_threshold
                if rdzv and self.runtime.staging.enabled:
                    arr = self.runtime.staging.acquire(src.shape, src.dtype)
                    np.copyto(arr, src)
                    pooled = True
                else:
                    arr = np.array(src)
                obj.release()
            nbytes = arr.nbytes
            if meta.path == "direct":
                self.stats["bytes_d2d"] += nbytes
            else:
                self.stats["bytes_staged"] += nbytes
            if nbytes > self.runtime.cfg.eager_threshold:
                self._start_rendezvous(meta, arr, nbytes, pooled)
                continue
            self.stats["eager"] += 1
            if self._reliability:
                meta.ack_req = True
            if meta.path != "direct" and nbytes <= INLINE_PAYLOAD_BYTES:
                meta.inline = np.asarray(arr).tobytes()  # §4.2.3 small msgs
                meta.digest = self._digest_for(meta.inline)
                if self._reliability:
                    self._track_unacked([meta])
                self.cluster.deliver(meta)
            else:
                payload = Message(msg_id=meta.msg_id, kind="payload",
                                  src=self.rank, dst=meta.dst, payload=arr,
                                  path=meta.path,
                                  digest=self._digest_for(arr))
                if self._reliability:
                    # meta+payload retransmit as a unit: whichever half
                    # was dropped, the receiver's pairing logic re-pairs
                    # and the duplicate half is suppressed
                    self._track_unacked([meta, payload])
                self.cluster.deliver(meta)
                self.cluster.deliver(payload)
            self.stats["sent"] += 1
            self.stats["bytes_out"] += nbytes

    # -- rendezvous protocol (sender side) -----------------------------
    def _start_rendezvous(self, meta: Message, arr: Any, nbytes: int,
                          pooled: bool = False) -> None:
        """RTS: announce the message, park the payload until the receiver
        signals CTS. Chunk size comes from the measured bandwidth-delay
        product of this rank pair (``Cluster.topology``). ``pooled`` marks
        a host payload staged in a StagingPool buffer — it is recycled
        when the receiver acks stream completion. All later stream state
        mutation happens on the net-send lane (CTS and credit arrivals
        are forwarded there), so no lock guards it."""
        chunk_b = self.runtime.cfg.chunk_bytes
        if chunk_b is None:
            target_s = self.runtime.cfg.chunk_target_ms / 1e3
            chunk_b = self.cluster.topology.chunk_bytes(
                self.rank, meta.dst, target_s,
                lo=MIN_CHUNK_BYTES, hi=MAX_CHUNK_BYTES)
        itemsize = meta.payload_dtype.itemsize
        elems = max(chunk_b // itemsize, 1)
        total_elems = nbytes // itemsize
        meta.protocol = "rdzv"
        meta.nchunks = max((total_elems + elems - 1) // elems, 1)
        meta.total_bytes = nbytes
        self._rdzv_out[meta.msg_id] = {
            "meta": meta, "flat": arr.reshape(-1), "arr": arr,
            "elems": elems, "pooled": pooled,
            "next_seq": 0,     # chunks handed to the network so far
            "credits": 0,      # window slots currently available
            "window": None,    # receiver's latest window target
            "acked": 0,        # receiver-reported completed uploads
        }
        self.stats["rendezvous"] += 1
        self.stats["sent"] += 1
        if self._reliability:
            # the RTS retransmits until the CTS clears it: a dropped
            # announcement (or a dropped CTS — the receiver re-CTSes a
            # duplicate RTS for a chunkless stream) cannot hang the send
            self._track_unacked([meta])
        self.cluster.deliver(meta)

    def _advance_stream(self, msg_id: int, credits: int,
                        window: Optional[int] = None, acked: int = 0,
                        initial: bool = False) -> None:
        """Net-send lane only. Fold ``credits`` into the stream's window
        and transmit every chunk the window now covers — the sender
        advances on per-chunk CTS credits, never on completion of the
        whole previous chunk, so ≥2 chunks stay in flight and the pump
        thread never transmits a payload window itself. The initial CTS
        grant opens the window.

        Adaptive shrink is honored here: each credit carries the
        receiver's latest window target and its cumulative completed
        uploads (``acked``), so the sender holds chunks — even with
        banked credits — while ``sent − acked`` is at or above the
        target. ``acked`` (not the credit count) keeps the in-flight
        accounting exact when the receiver defers credits under
        backlog."""
        state = self._rdzv_out.get(msg_id)
        if state is None:      # stream already fully handed to the network
            return
        state["credits"] += credits
        # VCs can reorder: each credit's acked is strictly newer than the
        # last (one per completed upload), so both acked and the window
        # target are accepted only from messages that ADVANCE the
        # completion count — a stale reordered grant must not re-widen a
        # window the receiver has since shrunk
        newer = acked > state["acked"]
        if newer:
            state["acked"] = acked
        if window and (initial or newer or state["window"] is None):
            state["window"] = window
        if not initial and credits:
            self.stats["credits_in"] += credits
        meta, flat, elems = state["meta"], state["flat"], state["elems"]
        while state["credits"] > 0 and state["next_seq"] < meta.nchunks:
            in_flight = state["next_seq"] - state["acked"]
            if state["window"] is not None \
                    and in_flight >= state["window"]:
                break          # receiver shrank the window: hold the rest
            k = state["next_seq"]
            piece = flat[k * elems:(k + 1) * elems]
            chunk = Message(msg_id=msg_id, kind="chunk", src=self.rank,
                            dst=meta.dst, seq=k, offset=k * elems,
                            nchunks=meta.nchunks, payload=piece,
                            path=meta.path,
                            digest=self._digest_for(piece))
            state["credits"] -= 1
            state["next_seq"] = k + 1
            self.stats["chunks_out"] += 1
            self.stats["bytes_out"] += piece.nbytes
            if in_flight + 1 > self.stats["max_window"]:
                self.stats["max_window"] = in_flight + 1
            self.cluster.deliver(chunk)
        if state["next_seq"] >= meta.nchunks:
            # stream fully transmitted: drop the send state; a pooled
            # staging buffer stays parked until the completion ack
            if state["pooled"]:
                self._rdzv_bufs[msg_id] = (meta.dst, state["arr"])
            if self._reliability:
                # keep the payload resendable until the completion ack:
                # a lost tail chunk (or a NACK) replays from here
                self._rdzv_sent[msg_id] = {
                    "meta": meta, "flat": flat, "elems": elems,
                    "dst": meta.dst, "attempts": 0,
                    "deadline": time.perf_counter()
                    + self.runtime.cfg.retry_backoff_s}
            del self._rdzv_out[msg_id]

    # -- rendezvous protocol (receiver side) ---------------------------
    def _transfer_backlog(self, dev: int) -> int:
        """Live queue depth of ``dev``'s transfer lane (jobs waiting
        behind the in-service one) — the drain-rate signal the adaptive
        credit controller feeds on."""
        if not self.runtime.cfg.transfer_thread:
            return 0
        ln = self.runtime.engine.peek("transfer", dev)
        return ln.backlog() if ln is not None else 0

    def _slab_bytes(self, exclude_mid: Optional[int] = None) -> int:
        """Landing-slab occupancy: bytes committed to OTHER in-progress
        incoming streams (the receiver-side memory concurrent windows
        are competing for). The deciding stream excludes itself — its
        slab is fully allocated at RTS no matter what the window does,
        so counting it would make any single stream larger than the slab
        limit collapse its own window to 1 for its whole lifetime."""
        return sum(st["meta"].total_bytes or 0
                   for mid, st in list(self._rdzv_in.items())
                   if mid != exclude_mid)

    def _prepare_rendezvous(self, meta: Message) -> None:
        """RTS received: pick the consumer-routed landing device, start
        allocating the flat landing slab ON that device (the allocation
        overlaps the CTS round-trip and the first chunk's network time),
        and signal CTS carrying the initial credit window — enough chunks
        in flight to cover the link's measured bandwidth-delay product
        (≥2, so the sender can always overlap chunk k+1's transmit with
        chunk k's upload here). With ``net_window=None`` the window is
        ADAPTIVE: the controller starts from the BDP but already folds in
        this rank's live transfer-lane backlog and slab occupancy, and
        every subsequent credit decision re-targets it mid-stream."""
        prior = self._rdzv_in.get(meta.msg_id)
        if prior is not None:       # retransmitted / duplicated RTS
            self.stats["dup_dropped"] += 1
            if prior["arrived"] == 0 and prior.get("cts") is not None:
                # no chunk ever arrived: the original CTS was likely
                # lost — resend it (double-granting is safe: the
                # sender's window-hold caps in-flight regardless)
                self.cluster.deliver(prior["cts"])
            return
        dev = self._landing_device(meta)
        rt = self.runtime
        chunk_b = max(meta.total_bytes // max(meta.nchunks, 1), 1)
        window = rt.cfg.net_window
        adaptive = window is None
        rx_queue, slab_bytes = 0, 0
        if adaptive:
            rx_queue = self._transfer_backlog(dev)
            slab_bytes = self._slab_bytes()
            window = self.cluster.topology.window_chunks(
                meta.src, self.rank, chunk_b,
                queue_depth=rx_queue, slab_bytes=slab_bytes)
        if meta.op == "reduce" and rt.cfg.coll_max_inflight_chunks:
            # every in-flight reduce chunk is a pending fused add on the
            # landing device's transfer lane: cap the pipeline depth so
            # accumulator-side device work stays bounded (satellite knob)
            window = min(window, rt.cfg.coll_max_inflight_chunks)
        window = max(1, min(window, meta.nchunks))
        state = {
            "meta": meta,
            "dev": dev,
            "uploads": {},           # seq -> (chunk-landed future, nbytes)
            "arrived": 0,
            "slab": None,            # device slab, chained through chunks
            # op='reduce' only: async device view of the target object —
            # the accumulator base the first chunk's lane job turns into
            # the landing slab (requested HERE, resolved off-lane, so the
            # transfer lane never deadlocks requesting it against itself)
            "reduce": meta.op == "reduce",
            "base_fut": None,
            # -- adaptive flow-control state --
            "adaptive": adaptive,
            "chunk_b": chunk_b,
            "win": window,           # current window target
            "outstanding": window,   # chunks granted but not yet uploaded
            "completed": 0,          # cumulative uploads retired (acked)
            # -- reliability layer --
            "cts": None,             # kept resendable for duplicate RTS
            "last_progress": time.perf_counter(),
            "nacks": 0,
        }
        device = rt._device(dev)
        if meta.nchunks > 1 and isinstance(device, TorchDevice):
            total = meta.total_bytes // meta.payload_dtype.itemsize
            if state["reduce"]:
                # reduce stream: the slab must START as the target's
                # current value (the accumulator), not zeros. Request the
                # view now so it resolves while the CTS round-trips; the
                # first chunk's lane job materializes it on-device. A
                # missing target (collective aborted before the stream
                # opened) leaves base_fut None: chunks fall back to the
                # parts path and the finish drops the result harmlessly.
                target = self.objects.get(meta.object_key)
                if target is not None:
                    state["base_fut"] = rt._request_device_view(target)
            else:
                def init(device=device, total=total,
                         dtype=meta.payload_dtype):
                    with _on_transfer_stream(device):
                        slab = torch.zeros(total, dtype=dtype,
                                           device=device.torch_device)
                    if device.is_cuda:
                        # tasks read the landed object on the compute
                        # stream: its block must outlive their work
                        slab.record_stream(device.compute_stream)
                    state["slab"] = slab
                # FIFO transfer lane: the init lands before any chunk
                # update, and chunk writes follow it on the same stream
                rt._async_transfer(dev, init)
        self._rdzv_in[meta.msg_id] = state
        if window < self.stats["window_min"] or not self.stats["window_min"]:
            self.stats["window_min"] = window
        cts = Message(msg_id=meta.msg_id, kind="cts",
                      src=self.rank, dst=meta.src,
                      credits=window, window=window,
                      rx_queue=rx_queue, rx_slab_bytes=slab_bytes)
        state["cts"] = cts
        self.cluster.deliver(cts)

    def _return_credit(self, msg_id: int, dst: int,
                       state: Dict[str, Any]) -> None:
        """Transfer-lane completion callback: one chunk's device copy
        retired. A pinned window returns one credit per completion, as
        before. The adaptive path re-targets the window HERE — mid-stream
        — with the lane's live backlog and slab occupancy: under backlog
        it withholds the credit entirely (``credits_deferred``; the
        sender's window shrinks by attrition, min 1 because a grant
        always fires when nothing is outstanding), and when the lane has
        drained it grants the deficit in one coalesced credit carrying
        the new window, the cumulative ``acked`` count, and the raw
        congestion signals."""
        state["completed"] += 1
        state["outstanding"] -= 1
        meta = state["meta"]
        if state["arrived"] >= meta.nchunks:
            return     # stream fully arrived: no credits left to spend
        q = self._transfer_backlog(state["dev"])
        if q > self.stats["rx_queue_peak"]:
            self.stats["rx_queue_peak"] = q
        if not state["adaptive"]:
            self.cluster.deliver(Message(
                msg_id=msg_id, kind="credit", src=self.rank, dst=dst,
                credits=1, window=state["win"],
                acked=state["completed"], rx_queue=q))
            return
        slab = self._slab_bytes(exclude_mid=msg_id)
        target = self.cluster.topology.window_chunks(
            meta.src, self.rank, state["chunk_b"],
            queue_depth=q, slab_bytes=slab)
        cap = self.runtime.cfg.coll_max_inflight_chunks
        if state["reduce"] and cap:
            target = min(target, cap)   # reduce pipeline stays bounded
        target = max(target, 1)
        if target != state["win"]:
            self.stats["window_adjusts"] += 1
            state["win"] = target
            if target < self.stats["window_min"] \
                    or not self.stats["window_min"]:
                self.stats["window_min"] = target
        grant = target - state["outstanding"]
        if grant <= 0:
            self.stats["credits_deferred"] += 1
            return
        state["outstanding"] += grant
        self.cluster.deliver(Message(
            msg_id=msg_id, kind="credit", src=self.rank, dst=dst,
            credits=grant, window=target, acked=state["completed"],
            rx_queue=q, rx_slab_bytes=slab))

    def _receive_chunk(self, msg: Message) -> None:
        """One chunk arrived (possibly out of order): hand it straight to
        the landing device's transfer lane and return to the pump — the
        next chunk's network receive overlaps this chunk's device copy.
        Each chunk is written into the preallocated slab in place
        (``_slab_write``), so the per-chunk device cost is chunk-sized (a
        concatenate at the end would re-copy the whole payload). When
        the upload completes, the flow-control credit decision runs
        (``_return_credit``) — the completion event that slides the
        sender's window forward, or deliberately lets it shrink."""
        state = self._rdzv_in.get(msg.msg_id)
        if state is None:
            if self._reliability and msg.msg_id in self._seen:
                # resent tail of a stream that already completed: the
                # completion ack was lost — re-ack so the sender releases
                # its parked buffer and retires the tail timer
                self.cluster.deliver(Message(msg_id=msg.msg_id, kind="ack",
                                             src=self.rank, dst=msg.src))
            return   # stream swept (peer removed) — drop the orphan chunk
        if msg.seq in state["uploads"]:
            self.stats["dup_dropped"] += 1   # duplicated/replayed chunk
            return
        if not self._verify(msg, msg.payload):
            # corrupted chunk = never arrived: no progress stamp, no
            # upload entry — the stalled-stream NACK re-requests exactly
            # this seq and the sender replays it from the parked payload
            self.stats["chunks_rejected"] += 1
            return
        state["last_progress"] = time.perf_counter()
        rt, dev = self.runtime, state["dev"]
        payload, offset = msg.payload, msg.offset
        direct = msg.path == "direct" and not isinstance(payload, np.ndarray)
        key = "bytes_d2d" if direct else "bytes_staged"
        self.stats[key] += payload.nbytes

        def fn():
            if state["slab"] is None and state["base_fut"] is not None:
                # first reduce chunk: turn the target's device view into
                # the accumulator slab, on the landing device. The future
                # resolves off-lane (task-completion callbacks), so this
                # wait cannot deadlock the transfer lane against itself.
                base_fut = state["base_fut"]
                state["base_fut"] = None
                space, base = base_fut.get(
                    timeout=rt.cfg.rdzv_finish_timeout_s)
                rt.futures.release(base_fut)
                device = rt._device(dev)
                # the view is a private snapshot: it becomes the slab
                base = device.upload(np.asarray(base)) if space == HOST \
                    else d2d_transfer(rt._device(space), device, base)
                state["slab"] = device.synchronize(base).reshape(-1)
            if state["slab"] is not None:
                # write straight into the slab, synchronously, so no
                # alias into the sender's pooled buffer survives.
                # op='reduce' fuses the add here, on the transfer lane —
                # the per-hop reduction the ring collectives pipeline.
                _slab_write(rt._device(dev), state["slab"], payload, offset,
                            state["reduce"])
                if state["reduce"]:
                    self.stats["coll_bytes_reduced"] += payload.nbytes
                return None
            if direct:
                return self._land_direct(payload, dev)
            # single-chunk landing: the Device API upload gives us a
            # private device copy of the view
            device = rt._device(dev)
            return device.synchronize(device.upload(np.asarray(payload)))
        fut = rt._async_transfer(dev, fn)
        state["uploads"][msg.seq] = (fut, payload.nbytes)
        state["arrived"] += 1
        self.stats["chunks_in"] += 1
        if state["reduce"]:
            # pipeline-depth telemetry: reduce chunks arrived but not yet
            # folded into the accumulator (the overlap the cap bounds)
            inflight = state["arrived"] - state["completed"]
            if inflight > self.stats["coll_chunks_in_flight_peak"]:
                self.stats["coll_chunks_in_flight_peak"] = inflight
        if msg.nchunks > 1:
            # the credit decision runs the moment this chunk's device
            # copy retires (fires on the transfer lane — never blocks
            # the pump)
            fut.add_done_callback(
                lambda _f, mid=msg.msg_id, src=msg.src, st=state:
                self._return_credit(mid, src, st))
        if state["arrived"] == msg.nchunks:
            # stream complete: the tail-upload waits and the handler run
            # move to the net-recv lane so the pump stays responsive; the
            # _rdzv_in entry keeps the barrier covering the completion
            self._net_recv.submit(
                lambda mid=msg.msg_id, last=msg.seq:
                self._finish_rendezvous(mid, last_seq=last))

    def _finish_rendezvous(self, msg_id: int, last_seq: int) -> None:
        """Net-recv lane: all chunks arrived — account pipeline overlap,
        await the tail device copies, and complete the stream: invoke the
        handler with a device-resident hetero_object for a 'send', or
        overwrite the keyed target object for a rendezvous 'put'. The
        reassembly entry stays in ``_rdzv_in`` until the completion ran —
        ``Cluster.barrier`` reads it as a busy signal, and popping early
        would let the barrier pass while the tail uploads (up to a whole
        chunk) are still in flight."""
        state = self._rdzv_in.get(msg_id)
        if state is None:
            return   # stream swept (peer removed) before completion
        try:
            meta, dev = state["meta"], state["dev"]
            uploads = state["uploads"]
            for seq, (fut, nb) in uploads.items():
                if seq != last_seq and fut.done():
                    self.stats["overlap_bytes"] += nb
            parts = []
            timeout = self.runtime.cfg.rdzv_finish_timeout_s
            for k in range(meta.nchunks):
                fut, _ = uploads[k]
                try:
                    # bounded wait on the net-recv lane, which tolerates
                    # blocking by design  # lint: allow-blocking
                    parts.append(fut.get(timeout=timeout))
                except TimeoutError:
                    raise TimeoutError(
                        f"rank {self.rank}: rendezvous stream "
                        f"{msg_id} from rank {meta.src} "
                        f"({meta.total_bytes} B, op={meta.op!r}): chunk "
                        f"{k}/{meta.nchunks} upload did not complete "
                        f"within {timeout:.0f}s on device {dev}'s "
                        "transfer lane "
                        f"(backlog={self._transfer_backlog(dev)})"
                    ) from None
                self.runtime.futures.release(fut)
            if state["slab"] is not None:
                assembled = state["slab"].reshape(meta.payload_shape)
            elif len(parts) == 1:
                assembled = parts[0].reshape(meta.payload_shape)
            else:   # other Device backends: plain host assembly
                assembled = np.concatenate([_host(p) for p in parts]) \
                    .reshape(meta.payload_shape)
            if meta.op in ("put", "reduce"):
                # rendezvous put (ROADMAP follow-up b): the stream lands
                # device-resident and becomes the target's only valid
                # copy — no receiver-side host staging. For op='reduce'
                # the slab already IS base + every chunk (the adds were
                # fused on the transfer lane), so the same rebind
                # completes the accumulation; without a slab (a single
                # chunk) the add happens on host here. A
                # missing target (aborted collective) drops the result.
                target = self.objects.get(meta.object_key)
                if target is not None:
                    if meta.op == "reduce" and state["slab"] is None:
                        fut = target.request_host(write=True)
                        arr = fut.get()  # lint: allow-blocking (net-recv lane)
                        np.add(arr, _host(assembled).reshape(arr.shape),
                               out=arr, casting="unsafe")
                        target.release()
                        self.stats["coll_bytes_reduced"] += \
                            int(meta.total_bytes or 0)
                    else:
                        if isinstance(assembled, np.ndarray):
                            assembled = self.runtime._device(dev).upload(
                                assembled)
                        self.runtime.rebind_device_copy(target, assembled,
                                                        dev)
                self._mark_done(meta, ack=False)  # explicit ack follows
                self.cluster.deliver(Message(msg_id=msg_id, kind="ack",
                                             src=self.rank, dst=meta.src))
                if meta.handler:
                    self._invoke(meta, target)
                return
            obj = self.runtime.adopt_device_array(assembled, dev)
            # completion ack: the sender recycles its parked pool buffer
            self._mark_done(meta, ack=False)
            self.cluster.deliver(Message(msg_id=msg_id, kind="ack",
                                         src=self.rank, dst=meta.src))
            self._invoke(meta, obj)
        finally:
            self._rdzv_in.pop(msg_id, None)

    def _handle(self, msg: Message):
        if self._reliability and msg.msg_id in self._seen \
                and msg.kind in ("meta", "payload", "put", "get"):
            # retransmission of a delivery that already completed: drop,
            # but re-ack so the sender stops resending (its ack was lost)
            self.stats["dup_dropped"] += 1
            if msg.ack_req:
                self.cluster.deliver(Message(msg_id=msg.msg_id, kind="ack",
                                             src=self.rank, dst=msg.src))
            return
        if msg.kind == "meta":
            self.stats["received"] += 1
            if msg.payload_shape is None:
                self._invoke(msg, None)
                self._mark_done(msg)
            elif msg.protocol == "rdzv":
                self._prepare_rendezvous(msg)
            elif msg.inline is not None:
                if not self._verify(msg, msg.inline):
                    return      # never-arrived: no ack → sender retries
                arr = np.frombuffer(
                    msg.inline, dtype=numpy_dtype(msg.payload_dtype)
                ).reshape(msg.payload_shape).copy()
                obj = self.runtime.hetero_object(arr)
                self._invoke(msg, obj)
                self._mark_done(msg)
            else:
                prior = self._pending_meta.pop(msg.msg_id, None)
                if prior is not None and prior.kind == "payload":
                    # the payload beat its metadata through the network
                    # (control and data ride different virtual channels)
                    obj = self._adopt_payload(prior, msg)
                    self._invoke(msg, obj)
                    self._mark_done(msg)
                else:
                    self._pending_meta[msg.msg_id] = msg
        elif msg.kind == "cts" or msg.kind == "credit":
            # window opened / slid: stream on the net-send lane, not the
            # pump — unrelated messages are never head-of-line blocked
            # behind this stream's payload (normally intercepted by
            # dispatch_control; this path serves Cluster subclasses that
            # enqueue control messages directly)
            self.dispatch_control(msg)
        elif msg.kind == "chunk":
            self._receive_chunk(msg)
        elif msg.kind == "ack":
            parked = self._rdzv_bufs.pop(msg.msg_id, None)
            if parked is not None:
                self.runtime.staging.release(parked[1])
            self._rdzv_sent.pop(msg.msg_id, None)
            self._ack_unacked(msg.msg_id)
        elif msg.kind == "payload":
            if not self._verify(msg, msg.payload):
                # never-arrived: its meta half (parked here or still in
                # flight) stays pending; the unacked meta+payload unit
                # retransmits and the clean payload re-pairs
                return
            meta = self._pending_meta.pop(msg.msg_id, None)
            if meta is None:       # payload raced ahead of metadata
                self._pending_meta[msg.msg_id] = msg
                return
            obj = self._adopt_payload(msg, meta)
            self._invoke(meta, obj)
            self._mark_done(meta)
        elif msg.kind == "put":
            if not self._verify(msg, msg.payload):
                return      # never-arrived: no ack → sender retries
            self.stats["received"] += 1
            target = self.objects.get(msg.object_key)
            if msg.op == "reduce":
                # eager accumulate (small collective hop): add on the
                # receiver's host copy — fixed per-stream arrival order
                # is the engine's job; this just folds one contribution
                if target is not None:
                    fut = target.request_host(write=True)
                    arr = fut.get()
                    np.add(arr, _host(msg.payload).reshape(arr.shape),
                           out=arr, casting="unsafe")
                    target.release()
                    self.stats["coll_bytes_reduced"] += \
                        int(msg.payload.nbytes)
            elif target is not None:
                if msg.path == "direct" \
                        and not isinstance(msg.payload, np.ndarray):
                    # consumer-routed device landing (ROADMAP follow-up
                    # d): no host staging on the receive side either —
                    # prefer the sender's hint, then a device already
                    # holding the target, then the ledger's least-loaded
                    pref = msg.consumer_device
                    if pref is None:
                        pref = next(iter(target.resident_devices()), None)
                    dev = self.runtime.pick_landing_device(preferred=pref)
                    local = self._land_direct(msg.payload, dev)
                    self.stats["bytes_d2d"] += msg.payload.nbytes
                    self.runtime.rebind_device_copy(target, local, dev)
                else:
                    fut = target.request_host(write=True)
                    arr = fut.get()
                    np.copyto(arr, np.asarray(msg.payload))
                    target.release()
            if msg.handler:
                self._invoke(msg, target)
            self._mark_done(msg)
        elif msg.kind == "get":
            self.stats["received"] += 1
            src_obj = self.objects.get(msg.object_key)
            self.send(msg.src, msg.handler, src_obj,
                      user={"object_key": msg.object_key},
                      path=msg.path or "host",
                      consumer_device=msg.consumer_device)
            self._mark_done(msg)

    def _land_direct(self, payload: Any, device_id: int) -> Any:
        """One Device API D2D landing for a foreign (cross-rank) device
        payload, observed into the local interconnect model — the single
        path every direct receive (monolithic, chunk, put) routes
        through."""
        return d2d_transfer(None, self.runtime._device(device_id), payload,
                            observer=self.runtime.topology.observe)

    def _landing_device(self, meta: Message) -> int:
        """Consumer-routed delivery: the sender's per-message
        ``consumer_device`` hint wins; for a rendezvous put, a device
        already holding the target object comes next; then this rank's
        ``route_to`` registration for the handler, then the handler's
        declared device-type affinity, and finally the residency ledger's
        least-loaded device — never a hardwired device 0."""
        ids = {d.info.device_id for d in self.runtime.devices}
        pref = meta.consumer_device
        if pref not in ids and meta.op in ("put", "reduce"):
            target = self.objects.get(meta.object_key)
            if target is not None:
                pref = next(iter(target.resident_devices()), None)
        if pref not in ids:      # absent or invalid hint: fall through
            pref = self.routes.get(meta.handler)
        return self.runtime.pick_landing_device(
            preferred=pref, device_type=H.affinity(meta.handler))

    def _adopt_payload(self, msg: Message, meta: Message) -> HeteroObject:
        """Land an incoming payload in the local runtime. DIRECT payloads
        (device arrays) are moved with one Device API transfer onto the
        consumer task's device (falling back to least-loaded) — never
        staged through host (paper §3.2.3 Fig. 7)."""
        if msg.path == "direct" and not isinstance(msg.payload, np.ndarray):
            dev = self._landing_device(meta)
            local = self._land_direct(msg.payload, dev)
            self.stats["bytes_d2d"] += msg.payload.nbytes
            return self.runtime.adopt_device_array(local, dev)
        self.stats["bytes_staged"] += msg.payload.nbytes
        return self.runtime.hetero_object(msg.payload)

    def _invoke(self, meta: Message, obj: Optional[HeteroObject]):
        fn = H.resolve(meta.handler)
        ctx = HandlerContext(self, meta)
        fn(ctx, obj)

    def _pump(self):
        while not self._stop:
            self._flush_outgoing()
            if self._hb_dst is not None or self._reliability:
                self._tick()
            try:
                _prio, _seq, msg = self.inbox.get(timeout=0.001)
            except queue.Empty:
                continue
            if msg is None:
                return
            if msg is _FLUSH:
                continue          # woken to flush outgoing; loop does it
            self._busy_enter()    # popped but effects not yet visible
            try:
                self._handle(msg)
            except BaseException as e:  # bad message must not kill the rank
                self._record_handler_error(e)
            finally:
                self._busy_exit()

    def _record_handler_error(self, exc: BaseException) -> None:
        """Route a swallowed pump/handler exception to the error sink:
        counted in ``stats["handler_errors"]``, bounded trace kept for
        ``check()`` (strict mode re-raises at the next barrier)."""
        self.stats["handler_errors"] += 1
        self._errors.append(exc)
        del self._errors[:-50]
        if not (self._stop or self.runtime.cfg.strict_errors):
            import traceback
            traceback.print_exception(type(exc), exc, exc.__traceback__)

    def check(self) -> None:
        """Strict mode: re-raise the first swallowed pump-handler error
        (``Cluster.barrier`` calls this after draining)."""
        if self._errors and self.runtime.cfg.strict_errors:
            raise RuntimeError(
                f"rank {self.rank}: {self.stats['handler_errors']} "
                "swallowed handler error(s)") from self._errors[0]

    # -- rendezvous-state hygiene (peer loss / shutdown) ---------------
    def state_gauges(self) -> Dict[str, int]:
        """Leak gauges: live rendezvous/protocol state entries — all zero
        once every stream completed or was swept — plus the cumulative
        integrity counters (zero on a clean, uncorrupted link)."""
        with self._unacked_lock:
            unacked = len(self._unacked)
        return {"rdzv_out": len(self._rdzv_out),
                "rdzv_in": len(self._rdzv_in),
                "rdzv_bufs": len(self._rdzv_bufs),
                "pending_meta": len(self._pending_meta),
                "rdzv_sent": len(self._rdzv_sent),
                "unacked": unacked,
                "checksum_fail": self.stats["checksum_fail"],
                "chunks_rejected": self.stats["chunks_rejected"],
                "coll_bytes_reduced": self.stats["coll_bytes_reduced"],
                "coll_chunks_in_flight_peak":
                    self.stats["coll_chunks_in_flight_peak"],
                "coll_aborts": self.stats["coll_aborts"]}

    def _sweep_out_streams(self, peer: Optional[int] = None
                           ) -> Dict[str, int]:
        """Sweep the SEND-side rendezvous state tied to ``peer`` (``None``
        = all peers): parked outgoing streams whose CTS/credits will
        never arrive, and pooled buffers whose completion ack is lost —
        their staging buffers return to the pool. ``_rdzv_out`` and
        ``_rdzv_bufs`` are mutated only on the net-send lane, so this
        must run THERE (or after the lane is joined, at shutdown) —
        never concurrently with ``_advance_stream``, which may still be
        handing out zero-copy views of the very buffer being released."""
        swept = {"rdzv_out": 0, "rdzv_bufs": 0, "rdzv_sent": 0}
        for mid, st in list(self._rdzv_out.items()):
            if peer is None or st["meta"].dst == peer:
                del self._rdzv_out[mid]
                if st["pooled"]:
                    self.runtime.staging.release(st["arr"])
                swept["rdzv_out"] += 1
        for mid, st in list(self._rdzv_sent.items()):
            if peer is None or st["dst"] == peer:
                del self._rdzv_sent[mid]
                swept["rdzv_sent"] += 1
        for mid, (dst, buf) in list(self._rdzv_bufs.items()):
            if peer is None or dst == peer:
                del self._rdzv_bufs[mid]
                self.runtime.staging.release(buf)
                swept["rdzv_bufs"] += 1
        return swept

    def _sweep_in_state(self, peer: Optional[int] = None) -> Dict[str, int]:
        """Sweep the RECEIVE-side state tied to ``peer`` (``None`` = all):
        in-progress reassembly entries and orphaned metadata halves —
        the leaks an elastic rescale would otherwise accumulate. Orphan
        chunks for a swept stream are dropped by ``_receive_chunk``."""
        swept = {"rdzv_in": 0, "pending_meta": 0}
        for mid, st in list(self._rdzv_in.items()):
            if peer is None or st["meta"].src == peer:
                if self._rdzv_in.pop(mid, None) is not None:
                    swept["rdzv_in"] += 1
        for mid, m in list(self._pending_meta.items()):
            if peer is None or m.src == peer:
                if self._pending_meta.pop(mid, None) is not None:
                    swept["pending_meta"] += 1
        return swept

    def remove_peer(self, peer: int) -> Dict[str, int]:
        """A peer left the cluster mid-stream (elastic rescale): sweep
        every rendezvous stream to/from it and release the pooled
        buffers its lost CTS/credit/ack messages left parked. The whole
        send-side sweep runs on the net-send lane (the only mutator of
        ``_rdzv_out``/``_rdzv_bufs``), so it cannot race a concurrent
        ``_advance_stream``; the receive-side sweep runs here. Returns
        the per-kind swept counts."""
        timeout = self.runtime.cfg.peer_sweep_timeout_s
        try:
            fut: HFuture = HFuture()
            self._net_send.submit(
                lambda p=peer: self._sweep_out_streams(p), fut)
            swept = dict(fut.get(timeout=timeout))
        except RuntimeError:       # lane already stopped: sweep inline
            swept = dict(self._sweep_out_streams(peer))
        except TimeoutError:
            raise TimeoutError(
                f"rank {self.rank}: removing peer {peer}: the net-send "
                f"lane did not run the stream sweep within {timeout:.0f}s "
                f"(lane backlog={self._net_send.backlog()}, "
                f"live streams={sorted(self._rdzv_out)})") from None
        with self._unacked_lock:
            for mid in [m for m, st in self._unacked.items()
                        if st["dst"] == peer]:
                del self._unacked[mid]
        swept.update(self._sweep_in_state(peer))
        return swept

    def reset_peer_state(self) -> Dict[str, int]:
        """Full protocol-state reset after THIS rank rejoins from a
        partition/freeze (elastic grow): every parked stream, pending
        retransmit and reassembly entry refers to a world that moved on
        — sweep them all so the rank starts clean."""
        swept = self.remove_peer(None)  # peer=None sweeps every peer
        with self._unacked_lock:
            self._unacked.clear()
        return swept

    def shutdown(self):
        self._stop = True
        self.enqueue(None)
        self._thread.join(timeout=self.runtime.cfg.pump_join_timeout_s)
        self.runtime.shutdown()
        # gauge hygiene (sanitizer): on a clean run every leak gauge must
        # have drained BEFORE the sweeps below reclaim stranded state —
        # the sweeps exist for faulted runs, not as a leak amnesty. The
        # check is captured here and raised after the sweeps so teardown
        # still completes. Skipped when a FaultInjector is attached
        # (killed peers legitimately strand streams) or this rank is dead.
        leak = None
        if (sanitizer.current() is not None and self.runtime.cfg.sanitize
                and self.cluster.faults is None):
            leak = sanitizer.gauge_leak_report(self)
        # lanes are drained and joined: release whatever rendezvous
        # state in-flight shutdown stranded (pooled buffers back to the
        # pool, reassembly/metadata entries dropped)
        self._sweep_out_streams()
        self._sweep_in_state()
        if leak is not None:
            san = sanitizer.current()
            if san is not None:
                san.note_gauge_leaks(1)
            raise sanitizer.SanitizerError(leak)


class FaultInjector:
    """Deterministic fault injection at the simulated network layer.

    Faults are modeled where real ones happen — on the wire and at the
    endpoints — so every recovery mechanism above (retries, NACKs,
    heartbeat detection, peer sweeps, chunk migration) is exercised by
    the same code paths production traffic uses:

    - ``kill_rank``: full partition — every message to OR from the rank
      is dropped (the process is "gone" to the network; its local pump
      keeps spinning, which is what a crashed-but-undetected peer looks
      like to everyone else).
    - ``freeze_rank``: straggler — messages touching the rank are
      delayed by the remaining freeze time (and observed into the
      ``InterconnectModel`` as latency samples, which is precisely the
      EWMA signal straggler detection reads). The rank keeps computing.
    - ``set_link``: per-directed-link loss/duplication/extra delay/
      bit-flip corruption, each applied per message from a seeded RNG —
      deterministic for a fixed seed and delivery order. Corruption
      flips one bit in a COPY of the payload/inline bytes (the sender's
      retained buffers stay pristine, so the reliability layer's
      retransmission carries the clean bytes).
    - ``fail_task``: plant deterministic kernel faults in a rank's local
      Runtime — the next ``times`` launches raise ``InjectedTaskFault``
      (retried up to ``RuntimeConfig.task_retries``, then surfaced).

    All decisions come from one seeded ``random.Random`` under a lock;
    ``stats`` counts every injected event."""

    def __init__(self, cluster: "Cluster", seed: int = 0):
        self.cluster = cluster
        self.rng = random.Random(seed)
        self._lock = sanitizer.make_lock("FaultInjector._lock")
        self.dead: Set[int] = set()
        self.frozen: Dict[int, float] = {}     # rank -> thaw instant
        self.links: Dict[Tuple[int, int], Dict[str, float]] = {}
        self.stats = {"dropped": 0, "duplicated": 0, "delayed": 0,
                      "kills": 0, "freezes": 0, "corrupted": 0,
                      "task_faults": 0}

    # -- fault controls -------------------------------------------------
    def kill_rank(self, rank: int) -> None:
        with self._lock:
            self.dead.add(rank)
            self.stats["kills"] += 1

    def revive_rank(self, rank: int) -> None:
        with self._lock:
            self.dead.discard(rank)

    def freeze_rank(self, rank: int, seconds: float) -> None:
        """Delay all traffic touching ``rank`` for ``seconds`` from now
        (extends an active freeze rather than stacking)."""
        with self._lock:
            self.frozen[rank] = max(self.frozen.get(rank, 0.0),
                                    time.perf_counter() + seconds)
            self.stats["freezes"] += 1

    def is_frozen(self, rank: int) -> bool:
        return self._frozen_for(rank) > 0.0

    def _frozen_for(self, rank: int) -> float:
        thaw = self.frozen.get(rank)
        if thaw is None:
            return 0.0
        remaining = thaw - time.perf_counter()
        if remaining <= 0:
            self.frozen.pop(rank, None)
            return 0.0
        return remaining

    def set_link(self, src: int, dst: int, drop: float = 0.0,
                 dup: float = 0.0, delay_s: float = 0.0,
                 corrupt: float = 0.0) -> None:
        """Per-directed-link fault profile: each message (src → dst) is
        dropped with probability ``drop``, duplicated with ``dup``,
        delayed an extra ``delay_s``, and — for messages carrying
        host-visible payload bytes — bit-flipped with probability
        ``corrupt``."""
        self.links[(src, dst)] = {"drop": drop, "dup": dup,
                                  "delay_s": delay_s, "corrupt": corrupt}

    def clear_link(self, src: int, dst: int) -> None:
        self.links.pop((src, dst), None)

    # -- the interception point ----------------------------------------
    def intercept(self, msg: Message) -> Tuple[bool, float, bool]:
        """Fault decision for one message: (drop, extra_delay_s,
        duplicate)."""
        with self._lock:
            if msg.src in self.dead or msg.dst in self.dead:
                self.stats["dropped"] += 1
                return True, 0.0, False
            delay = max(self._frozen_for(msg.src),
                        self._frozen_for(msg.dst))
            link = self.links.get((msg.src, msg.dst))
            dup = False
            if link is not None:
                if link["drop"] and self.rng.random() < link["drop"]:
                    self.stats["dropped"] += 1
                    return True, 0.0, False
                if link["dup"] and self.rng.random() < link["dup"]:
                    dup = True
                    self.stats["duplicated"] += 1
                delay += link["delay_s"]
            if delay > 0:
                self.stats["delayed"] += 1
            return False, delay, dup

    # -- corruption -----------------------------------------------------
    def maybe_corrupt(self, msg: Message) -> Message:
        """Bit-flip decision for one message: returns either ``msg``
        untouched or a shallow copy whose payload/inline bytes have one
        seeded bit flipped.

        The copy is essential: the sender retains the *original*
        ``Message`` objects for ack-timeout retransmission and tail
        resends, so mutating in place would poison every retry. Only
        host-visible bytes (np.ndarray / bytes) are candidates — DIRECT
        device payloads are private in-process snapshots a wire flip
        cannot reach (and hashing them would force a readback)."""
        with self._lock:
            link = self.links.get((msg.src, msg.dst))
            if (link is None or not link.get("corrupt")
                    or self.rng.random() >= link["corrupt"]):
                return msg
            if msg.inline is not None and len(msg.inline) > 0:
                buf = bytearray(msg.inline)
                bit = self.rng.randrange(len(buf) * 8)
                buf[bit >> 3] ^= 1 << (bit & 7)
                self.stats["corrupted"] += 1
                return dataclasses.replace(msg, inline=bytes(buf))
            pay = msg.payload
            if isinstance(pay, np.ndarray) and pay.nbytes > 0:
                flipped = np.array(pay, copy=True)
                flat = flipped.reshape(-1).view(np.uint8)
                bit = self.rng.randrange(flat.size * 8)
                flat[bit >> 3] ^= 1 << (bit & 7)
                self.stats["corrupted"] += 1
                return dataclasses.replace(msg, payload=flipped)
            return msg

    def fail_task(self, rank: int, times: int = 1) -> None:
        """Plant ``times`` kernel faults in ``rank``'s local Runtime: the
        next ``times`` task launches there raise ``InjectedTaskFault``
        from inside ``_launch``, exercising retry (``task_retries``) and
        strict-error surfacing through the production failure path."""
        rt = self.cluster.ranks[rank].runtime
        with rt._lock:
            rt._inject_task_faults += times
        with self._lock:
            self.stats["task_faults"] += times


@dataclasses.dataclass
class HandlerContext:
    rank: Rank
    message: Message

    @property
    def user(self):
        return self.message.user

    def send(self, dst, handler_name, obj=None, **kw):
        return self.rank.send(dst, handler_name, obj, **kw)


class Cluster:
    """In-process rank set with a simulated cut-through network.
    ``latency_s`` and ``bw_bytes_per_s`` let benchmarks model
    interconnect behaviour; the 'direct' path skips the host-staging cost
    the way GPU-aware MPI does.

    Transmission is modeled AT THE LINK, not in the sender (ROADMAP
    follow-up d): each directed (src, dst) pair with a nonzero simulated
    delay gets its own ``("link", src, dst)`` lane on a cluster-wide
    progress engine, which serializes that link's payloads — so chunk
    k+1's transmit overlaps chunk k's receive-side upload across the
    whole credit window, instead of the old store-and-forward model that
    billed transmission in the sender's pump and kept exactly one chunk
    in flight. The wire is occupied only for each message's
    SERIALIZATION time (bytes/bandwidth); propagation latency delays
    delivery on a per-link ``linkprop`` lane without holding the wire —
    true cut-through, so a long-fat link does not serialize messages
    behind each other's flight time. Control messages (CTS, credits,
    acks — anything 0-byte) ride a higher-priority virtual channel on
    the link, the way real fabrics keep flow control out from behind
    bulk data.

    The control VC is NOT free: it has a finite per-link drain rate
    (``ctrl_drain_per_s`` messages/second, a NIC-message-rate analogue)
    and its own ``_ctrl_free`` occupancy schedule mirroring the payload
    wire's ``_wire_free`` — so a credit storm queues behind itself and
    is billed real simulated time, instead of the old model where
    control chatter cost nothing and naive per-chunk crediting looked
    free. ``ctrl_stats`` counts control messages and their accumulated
    queueing. The drain rate is DERIVED by default
    (``ctrl_drain_per_s=None``): an EWMA over the measured
    ``dispatch_control`` service time, seeded at 200k msgs/s and clamped
    to [20k, 5M] — the same measure-then-derive pattern chunk sizing
    uses with link bandwidth. Passing an explicit value pins the rate,
    and ``ctrl_drain_per_s=0`` restores the unbilled channel.

    ``topology`` is the rank-pair ``InterconnectModel``: every
    payload-carrying delivery is timed into it, and the rendezvous
    protocol sizes its chunks and credit windows from the measured
    bandwidth-delay product of the (src, dst) pair."""

    _CONTROL_KINDS = frozenset({"cts", "ack", "credit", "get", "nack"})

    # adaptive control-drain seed and clamps (messages/second): the seed
    # matches the old constant; the clamps keep one outlier service
    # sample from pricing the channel absurdly in either direction
    CTRL_DRAIN_SEED = 200e3
    CTRL_DRAIN_MIN = 20e3
    CTRL_DRAIN_MAX = 5e6
    _CTRL_EWMA_ALPHA = 0.25

    def __init__(self, n_ranks: int, rt_config: Optional[RuntimeConfig] = None,
                 latency_s: float = 0.0, bw_bytes_per_s: float = 0.0,
                 ctrl_drain_per_s: Optional[float] = None):
        self.latency_s = latency_s
        self.bw = bw_bytes_per_s
        # control-VC drain rate (ROADMAP 5d): ``None`` derives it from the
        # measured control-message service time — an EWMA over what each
        # ``dispatch_control`` actually costs, the same
        # measure-then-derive pattern chunk sizing uses with bandwidth —
        # seeded at the old 200k/s constant. An explicit value pins the
        # rate (benchmarks/tests); 0 restores the unbilled channel.
        self._ctrl_adaptive = ctrl_drain_per_s is None
        self._ctrl_pinned = (0.0 if ctrl_drain_per_s is None
                             else float(ctrl_drain_per_s))
        self._ctrl_service_ewma = 1.0 / self.CTRL_DRAIN_SEED
        self.topology = InterconnectModel()
        self.net = ProgressEngine(name="net")
        self._inflight = 0             # messages on a link lane right now
        self._inflight_lock = sanitizer.make_lock("Cluster._inflight_lock")
        # per-directed-link wire model: the perf_counter instant the wire
        # is next free. Advanced by the EXACT modeled transmission time,
        # so sleep overshoot never accumulates across a chunk stream
        # (only each message's own delivery jitters, the wire schedule
        # stays faithful). Written only from that link's serial lane.
        self._wire_free: Dict[Tuple[int, int], float] = {}
        # control-VC occupancy schedule (finite drain rate): written from
        # ANY delivering thread at reservation time, hence its own lock
        self._ctrl_free: Dict[Tuple[int, int], float] = {}
        self._ctrl_lock = sanitizer.make_lock("Cluster._ctrl_lock")
        self.ctrl_stats = {"msgs": 0, "queued_s": 0.0,
                           "adaptive": self._ctrl_adaptive,
                           "drain_per_s": (self.CTRL_DRAIN_SEED
                                           if self._ctrl_adaptive
                                           else self._ctrl_pinned),
                           "service_ewma_s": self._ctrl_service_ewma}
        # fault injection (None = perfect network, zero overhead on the
        # delivery path beyond one attribute check)
        self.faults: Optional[FaultInjector] = None
        self.ranks = [Rank(self, r, rt_config) for r in range(n_ranks)]

    @property
    def ctrl_drain(self) -> float:
        """Current control-VC drain rate (messages/second). Pinned mode
        returns the constructor value verbatim; adaptive mode inverts the
        measured per-message service-time EWMA, clamped to
        [CTRL_DRAIN_MIN, CTRL_DRAIN_MAX]."""
        if not self._ctrl_adaptive:
            return self._ctrl_pinned
        rate = 1.0 / max(self._ctrl_service_ewma, 1e-9)
        return min(max(rate, self.CTRL_DRAIN_MIN), self.CTRL_DRAIN_MAX)

    def _observe_ctrl_service(self, dt: float) -> None:
        """Fold one measured control-dispatch service time into the EWMA
        the adaptive drain rate derives from."""
        if not self._ctrl_adaptive or dt <= 0:
            return
        with self._ctrl_lock:
            self._ctrl_service_ewma += self._CTRL_EWMA_ALPHA * (
                dt - self._ctrl_service_ewma)
            self.ctrl_stats["service_ewma_s"] = self._ctrl_service_ewma
            self.ctrl_stats["drain_per_s"] = self.ctrl_drain

    def fault_injector(self, seed: int = 0) -> "FaultInjector":
        """Attach deterministic fault injection and engage the
        reliability layer (ack/retry/NACK retransmission) on every rank —
        an injected drop then surfaces as a retransmit, never a hang.
        Idempotent; returns the injector."""
        if self.faults is None:
            self.faults = FaultInjector(self, seed)
        for r in self.ranks:
            r._reliability = True
        return self.faults

    @staticmethod
    def _sleep_until(deadline: float) -> None:
        """Wait until a modeled delivery instant without burning a core:
        coarse GIL-releasing sleep for the bulk, a yielding spin only for
        the final ~150 µs. A full-duration spin would occupy a whole CPU
        for every millisecond of simulated wire time — on small hosts
        that starvation re-creates the very head-of-line blocking the
        cut-through model removes."""
        san = sanitizer.current()
        if san is not None:
            # simulated wire time is a sleep: flag it if it ever runs on
            # a strict lane (link/linkctl lanes are blocking-allowed)
            san.note_sleep(max(deadline - time.perf_counter(), 0.0),
                           "Cluster._sleep_until")
        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return
            if remaining > 150e-6:
                # simulated wire latency on the link/linkctl lanes, which
                # tolerate blocking by design  # lint: allow-blocking
                time.sleep(remaining - 100e-6)
            else:
                time.sleep(0)  # sched_yield  # lint: allow-blocking

    def _priority(self, msg: Message, nbytes: int) -> int:
        """Virtual channels on the simulated wire: control traffic first,
        eager payloads next, bulk rendezvous chunks last — a small
        message never queues behind a whole streamed window."""
        if nbytes == 0 or msg.kind in self._CONTROL_KINDS:
            return 0
        return 2 if msg.kind == "chunk" else 1

    def deliver(self, msg: Message):
        """Hand a message to the network, via the fault injector when one
        is attached: a dropped message vanishes here (the reliability
        layer's retries are the only recovery), a duplicated one is
        transmitted twice, and a delayed one (frozen rank / slow link)
        parks on a per-link fault lane whose delivery is *observed* into
        the interconnect model — injected slowness shows up in the same
        EWMA latency telemetry real slowness would."""
        fi = self.faults
        if fi is not None:
            drop, extra, dup = fi.intercept(msg)
            if drop:
                return
            # one corruption decision per wire crossing; a duplicate
            # carries the same (possibly flipped) bytes — dedup and
            # checksum verification both see what the wire produced
            msg = fi.maybe_corrupt(msg)
            if dup:
                self._transmit(msg)
            if extra > 0:
                self._deliver_delayed(msg, extra)
                return
        self._transmit(msg)

    def _deliver_delayed(self, msg: Message, delay: float) -> None:
        """Injected-fault delay: park the message on the per-link fault
        lane, transmit after ``delay``, and observe the elapsed time as a
        (latency-classed) topology sample — the straggler signal."""
        with self._inflight_lock:
            self._inflight += 1
        t0 = time.perf_counter()
        t_deliver = t0 + delay
        link = (msg.src, msg.dst)

        def run():
            try:
                self._sleep_until(t_deliver)
                self._transmit(msg)
                nbytes = msg.payload.nbytes if msg.payload is not None \
                    else (len(msg.inline) if msg.inline is not None else 0)
                # 0-byte control messages observe as 1 byte: a latency
                # sample, exactly what a delayed heartbeat should be
                self.topology.observe(msg.src, msg.dst, max(nbytes, 1),
                                      time.perf_counter() - t0)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

        try:
            self.net.submit("fault", link, run)
        except RuntimeError:        # engine shut down: drop, roll back
            with self._inflight_lock:
                self._inflight -= 1

    def _transmit(self, msg: Message):
        """The fault-free network: when the simulated link has a nonzero
        delay the message is queued on a link lane (cut-through — the
        LINK serializes transmission, the sender is free immediately);
        zero-delay messages land in the destination inbox directly.
        Control traffic (priority 0) rides a dedicated per-link control
        lane — the virtual channel real fabrics use — so a credit or CTS
        is never stuck behind an in-service bulk chunk; payload messages
        serialize on the wire's ``_wire_free`` schedule, non-preemptively,
        priority-ordered."""
        nbytes = msg.payload.nbytes if msg.payload is not None else \
            (len(msg.inline) if msg.inline is not None else 0)
        delay = self.latency_s
        if self.bw and nbytes:
            delay += nbytes / self.bw
        dst = self.ranks[msg.dst]
        if delay <= 0:
            t0 = time.perf_counter()
            if not dst.dispatch_control(msg):
                dst.enqueue(msg, msg_priority(msg, nbytes))
            if nbytes:
                self.topology.observe(msg.src, msg.dst, nbytes,
                                      time.perf_counter() - t0)
            return
        prio = msg_priority(msg, nbytes)
        link = (msg.src, msg.dst)
        if prio == PRIO_CONTROL:
            # control VC: billed against the finite per-link drain rate.
            # The delivery instant is reserved on the _ctrl_free schedule
            # up front (monotonic per link, so control stays ordered),
            # then short waits deliver inline in the calling thread —
            # waking an idle per-link control lane costs several hundred
            # µs on a busy host, far more than the simulated latency —
            # and queued-up waits (a credit storm billing real time) move
            # to the linkctl lane so the caller never stalls on them.
            t0 = time.perf_counter()
            t_deliver = t0 + delay
            if self.ctrl_drain > 0:
                service = 1.0 / self.ctrl_drain
                with self._ctrl_lock:
                    start = max(t0, self._ctrl_free.get(link, 0.0))
                    self._ctrl_free[link] = start + service
                    self.ctrl_stats["msgs"] += 1
                    self.ctrl_stats["queued_s"] += start - t0
                t_deliver = start + service + delay
            ctl = self.net.peek("linkctl", link)
            if t_deliver - t0 <= 100e-6 and (ctl is None or not ctl.busy()):
                self._sleep_until(t_deliver)
                ts = time.perf_counter()
                if not dst.dispatch_control(msg):
                    dst.enqueue(msg, prio)
                self._observe_ctrl_service(time.perf_counter() - ts)
                return
            with self._inflight_lock:
                self._inflight += 1

            def transmit_ctrl():
                try:
                    self._sleep_until(t_deliver)
                    ts = time.perf_counter()
                    if not dst.dispatch_control(msg):
                        dst.enqueue(msg, prio)
                    self._observe_ctrl_service(time.perf_counter() - ts)
                finally:
                    with self._inflight_lock:
                        self._inflight -= 1

            try:
                self.net.submit("linkctl", link, transmit_ctrl)
            except RuntimeError:    # engine shut down: drop, roll back
                with self._inflight_lock:
                    self._inflight -= 1
            return
        with self._inflight_lock:
            self._inflight += 1

        def finish(t0: float):
            try:
                if not dst.dispatch_control(msg):
                    dst.enqueue(msg, prio)
                if nbytes:
                    self.topology.observe(msg.src, msg.dst, nbytes,
                                          time.perf_counter() - t0)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

        def transmit():
            # cut-through: the wire is OCCUPIED only for the
            # serialization time (bytes/bandwidth); propagation latency
            # delays delivery but does not hold the wire — billing
            # latency as occupancy would make every message on a
            # long-fat link serialize behind the previous one's whole
            # flight time, which no real fabric does. The link lane
            # paces occupancy; the per-link propagation lane sleeps out
            # the latency (delivery instants are monotonic per link, so
            # its FIFO preserves order).
            t0 = time.perf_counter()
            serialize = nbytes / self.bw if self.bw and nbytes else 0.0
            start = max(t0, self._wire_free.get(link, 0.0))
            self._wire_free[link] = start + serialize
            t_deliver = start + serialize + self.latency_s
            if self.latency_s > 0:
                self._sleep_until(start + serialize)

                def propagate():
                    self._sleep_until(t_deliver)
                    finish(t0)
                try:
                    self.net.submit("linkprop", link, propagate)
                    return
                except RuntimeError:    # engine shutting down: inline
                    pass
            self._sleep_until(t_deliver)
            finish(t0)

        try:
            self.net.submit("link", link, transmit, priority=prio)
        except RuntimeError:        # engine shut down: drop, roll back
            with self._inflight_lock:
                self._inflight -= 1

    def _rank_busy(self, r: Rank) -> bool:
        with r._out_lock:
            if r.outgoing:
                return True
        return (not r.inbox.empty() or r._active
                or bool(r._rdzv_out) or bool(r._rdzv_in)
                or r._net_send.busy() or r._net_recv.busy())

    def _net_busy(self) -> bool:
        with self._inflight_lock:
            return self._inflight > 0

    def _barrier_diagnostics(self) -> str:
        """What the cluster is stuck on: per-busy-rank queue depths, lane
        backlogs, live rendezvous stream ids and unacked reliable sends,
        plus the network's in-flight count and control-VC pressure —
        attached to the barrier-timeout error so a hang names its
        culprit instead of just timing out."""
        with self._inflight_lock:
            inflight = self._inflight
        parts = [f"net: {inflight} msg(s) in flight on link lanes, "
                 f"ctrl VC {self.ctrl_stats['msgs']} msgs "
                 f"({self.ctrl_stats['queued_s'] * 1e3:.1f} ms queued)"]
        dead = self.faults.dead if self.faults is not None else frozenset()
        for r in self.ranks:
            if r.rank in dead or not self._rank_busy(r):
                continue
            lanes = r.runtime.engine.backlogs()
            with r._out_lock:
                nout = len(r.outgoing)
            with r._unacked_lock:
                unacked = sorted(r._unacked)
            parts.append(
                f"rank {r.rank}: inbox={r.inbox.qsize()} "
                f"active={r._active} outgoing={nout} "
                f"lane_backlogs={lanes or '{}'} "
                f"rdzv_out={sorted(r._rdzv_out)} "
                f"rdzv_in={sorted(r._rdzv_in)} "
                f"pending_meta={sorted(r._pending_meta)} "
                f"unacked={unacked}")
        return "; ".join(parts)

    def barrier(self, timeout: float = 60.0):
        """Wait until every rank's message work has drained — inboxes,
        pump activity, rendezvous state, net-send/net-recv lanes, and
        messages in flight on the simulated links — then barrier the
        runtimes. Requires TWO consecutive all-idle sweeps: every handoff
        (pump → lane → link → inbox) marks its next stage busy before the
        previous one goes idle, so anything in flight during sweep one is
        visible somewhere by sweep two. Ranks the fault injector has
        killed are skipped — they are partitioned, not draining."""
        deadline = clock.now() + timeout
        idle_sweeps = 0
        while idle_sweeps < 2:
            dead = self.faults.dead if self.faults is not None \
                else frozenset()
            if self._net_busy() \
                    or any(self._rank_busy(r) for r in self.ranks
                           if r.rank not in dead):
                idle_sweeps = 0
                if clock.now() > deadline:
                    diag = self._barrier_diagnostics()
                    if sanitizer.current() is not None:
                        # wait-graph verdict: turn the raw backlog dump
                        # into a named root cause (deadlock cycle across
                        # ranks/streams, or the slowest lane)
                        diag += ("; waitgraph: "
                                 + sanitizer.waitgraph_verdict(self))
                    raise TimeoutError(
                        f"cluster barrier timeout after {timeout:.1f}s — "
                        + diag)
                time.sleep(0.001)
            else:
                idle_sweeps += 1
        dead = self.faults.dead if self.faults is not None else frozenset()
        for r in self.ranks:
            if r.rank in dead:
                continue
            r.runtime.barrier(timeout=max(deadline - clock.now(), 1.0))
            r.check()      # strict mode: surface swallowed handler errors

    def shutdown(self):
        # a sanitizer gauge-leak assertion on one rank must not leave the
        # remaining ranks (and the network engine) running: finish the
        # teardown, then re-raise the first failure
        errs: List[BaseException] = []
        for r in self.ranks:
            try:
                r.shutdown()
            except sanitizer.SanitizerError as e:
                errs.append(e)
        self.net.shutdown()
        if errs:
            raise errs[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
