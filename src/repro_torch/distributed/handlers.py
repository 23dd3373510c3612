"""Handler registry — PREMA's remote method invocations (paper §1.1;
``repro/distributed/handlers.py`` at the same path).

Handlers are named host functions invoked on the owner of a mobile object,
possibly on a remote rank. ``@handler`` registers by name so every rank
resolves the same code from message metadata (the moral equivalent of
DEFINE_MP_HANDLER in Fig. 5).

A handler may declare a consumer **device-type affinity**
(``@handler(name=..., device_type="gpu")``): the receiving rank routes
incoming payloads for that handler onto a device of that type (least
loaded, per the residency ledger) instead of the global least-loaded
fallback — the coarse-grained half of consumer-routed delivery; the fine
half is the per-message ``consumer_device`` hint.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}
_AFFINITY: Dict[str, str] = {}


def handler(fn: Callable = None, *, name: str = None,
            device_type: Optional[str] = None):
    def wrap(f):
        key = name or f.__name__
        if key in _REGISTRY and _REGISTRY[key] is not f:
            raise ValueError(f"handler {key!r} already registered")
        _REGISTRY[key] = f
        if device_type is not None:
            _AFFINITY[key] = device_type
        f.handler_name = key
        return f
    if fn is not None:
        return wrap(fn)
    return wrap


def resolve(name: str) -> Callable:
    return _REGISTRY[name]


def affinity(name: Optional[str]) -> Optional[str]:
    """Device type the named handler wants its payloads landed on."""
    return _AFFINITY.get(name) if name else None


def registered() -> Dict[str, Callable]:
    return dict(_REGISTRY)
