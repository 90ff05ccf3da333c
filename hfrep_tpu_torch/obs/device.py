"""Device facts and memory snapshots of the card (``hfrep_tpu/obs/device.py``).

* :func:`device_facts` — what ``run.json`` records of the machine's
  devices: the backend, the card's name, compute capability, memory and
  SM count (``torch.cuda.get_device_properties``), and the CUDA version
  torch was built with (``torch.version.cuda``).
* :func:`memory_snapshot` — one ``memory`` event describing every card
  now: the caching allocator's bytes in use and its peak
  (``torch.cuda.memory_stats``).  ``high_water`` is the max of the peaks,
  the field the report's "memory high-water" column reads.

The JAX module's compile accounting (``jax.monitoring`` listeners) has
no counterpart: nothing in the port compiles at run time but the hand
kernels, which ``ops/_build.py`` builds once a process.
"""

from __future__ import annotations

import torch


def device_facts() -> dict:
    """The devices this process sees, as plain data; never raises."""
    try:
        facts = {"backend": "cuda" if torch.cuda.is_available() else "cpu",
                 "torch_cuda": torch.version.cuda,
                 "local_device_count": torch.cuda.device_count()}
        cards = []
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            cards.append({"name": p.name, "capability": f"{p.major}.{p.minor}",
                          "total_memory": int(p.total_memory),
                          "sm_count": int(p.multi_processor_count)})
        facts["cards"] = cards
        facts["device_kind"] = cards[0]["name"] if cards else "cpu"
        return facts
    except Exception as e:           # the manifest survives a broken runtime
        return {"error": str(e)}


def memory_snapshot(obs, **attrs) -> None:
    """Emit one ``memory`` event describing every card now (nothing on a
    machine without one)."""
    try:
        if not torch.cuda.is_available():
            return
        devices, high, live = [], 0, 0
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            in_use = int(stats.get("allocated_bytes.all.current", 0))
            peak = int(stats.get("allocated_bytes.all.peak", 0))
            devices.append({"id": f"cuda:{i}", "bytes_in_use": in_use,
                            "peak_bytes_in_use": peak})
            high, live = max(high, peak, in_use), live + in_use
        obs._emit({"type": "memory", "live_bytes": live, "high_water": high,
                   "devices": devices, **attrs})
    except Exception:                 # telemetry must never kill the run
        pass
