"""Where the train step's device time goes (counterpart of
``scripts/profile_step.py``): the step ``bench.build_setup`` builds, traced
under ``torch.profiler`` (CPU and CUDA activities) after its warm calls,
its device operations summed by name. The step is one CUDA graph on the
card (its first call the eager warm-up, its second the capture, both before
any timed call); the first line says ``# step: graph`` (or ``eager``).

    python -m carca_tpu_torch.profile_step [--config flagship|men|10m]
                                           [--batch N] [--top 25] [--calls 4]

Prints ``scripts/profile_step.py``'s table, one row per device operation
(kernel or copy) by total time: µs per train step, % of the summed device
time, launches per traced call, name; then the wall ms per step (host
clock around an unprofiled call that ends in a synchronize), the device
busy ms per step (the union of the operations' intervals, so overlapping
operations count once) and the busy share, busy over wall: the share of
the step's wall time in which the card runs something, 1 when the host
keeps it fed. Needs a CUDA card. ``device_trace`` is the aggregation
``chip_smoke.py`` uses too.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Iterable, List, Tuple

import torch

Op = Tuple[str, float, float]  # (name, start µs, end µs) of one device operation


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (µs)."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def device_ops(prof) -> List[Op]:
    """The device operations of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def op_table(ops: List[Op], steps: int, calls: int) -> List[Tuple[str, float, float, float]]:
    """(name, µs per step, % of the summed device time, launches per call)
    by total time, heaviest first, of ``ops`` over ``calls`` calls of
    ``steps`` steps in all."""
    by_name: Dict[str, List[float]] = {}
    for name, s, e in ops:
        by_name.setdefault(name, []).append(e - s)
    total = sum(sum(d) for d in by_name.values()) or 1.0
    rows = [(name, sum(d) / steps, 100.0 * sum(d) / total, len(d) / calls)
            for name, d in by_name.items()]
    return sorted(rows, key=lambda r: -r[1])


def device_trace(run: Callable[[], float], steps: int, calls: int = 1) -> dict:
    """``run`` (one call of ``steps`` steps, returning its host wall ms,
    ended by a synchronize) once to warm, once unprofiled, then ``calls``
    times under ``torch.profiler``: wall ms per step (unprofiled and
    profiled), device busy ms per step, the busy share, device operations
    per step and ``op_table``'s rows. Raises when the trace holds no
    device operation."""
    from torch.profiler import ProfilerActivity, profile

    run()
    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof_ms = sum(run() for _ in range(calls))
    ops = device_ops(prof)
    if not ops:
        raise RuntimeError("the profiler trace holds no device operation")
    n = steps * calls
    busy_ms = busy_us((s, e) for _, s, e in ops) / 1e3 / n
    return {"wall_ms_per_step": wall_ms / steps, "wall_profiled_ms_per_step": wall_prof_ms / n,
            "device_busy_ms_per_step": busy_ms, "busy_share": busy_ms / (wall_ms / steps),
            "device_ops_per_step": len(ops) / n, "table": op_table(ops, n, calls)}


def main() -> None:
    from carca_tpu_torch.bench import CONFIGS, build_setup

    ap = argparse.ArgumentParser(prog="python -m carca_tpu_torch.profile_step")
    ap.add_argument("--config", choices=CONFIGS, default="flagship")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--calls", type=int, default=4,
                    help="traced calls (each inner_steps train steps)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("carca_tpu_torch.profile_step traces a CUDA card; none is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = build_setup(args.config, args.batch)
    for _ in range(2):  # the graph's warm-up and capture, outside device_trace's calls
        s.state, _ = s.step(s.state, s.attrs, s.dd.arrays, s.chunks[0])

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.state, _ = s.step(s.state, s.attrs, s.dd.arrays, s.chunks[0])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    t = device_trace(run, s.inner, args.calls)
    n = args.calls * s.inner
    print(f"# step: {s.step.mode}")
    print(f"# {torch.cuda.get_device_name(0)}: {args.config}, batch {s.tc.batch_size}, "
          f"{n} train steps in {args.calls} calls, device total "
          f"{sum(r[1] for r in t['table']) * n / 1e3:.2f} ms")
    print(f"{'us/step':>9}  {'%':>5}  {'calls':>5}  op")
    for name, us, pct, per_call in t["table"][:args.top]:
        print(f"{us:9.1f}  {pct:5.1f}  {per_call:5.0f}  {name[:120]}")
    print(f"# wall ms per step {t['wall_ms_per_step']:.4f} (profiled "
          f"{t['wall_profiled_ms_per_step']:.4f}), device busy ms per step "
          f"{t['device_busy_ms_per_step']:.4f}, busy share {t['busy_share']:.4f}, "
          f"device ops per step {t['device_ops_per_step']:.1f}")


if __name__ == "__main__":
    main()
