"""Profile the flagship ring step on the device and print its per-op budget.

Traces a few steps with jax.profiler, then parses the Perfetto trace
(*.trace.json.gz) directly, with nothing but the standard library.
Aggregates device-track event durations by op name and prints the top
entries with per-step cost.

Env: PBTE_PROF_STEPS (default 3), PBTE_PROF_DIR (default: a new temporary
directory), bench shape overrides as in bench.py. `--parse DIR` re-reads an
existing trace directory.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _busy_us(spans):
    """Length of the union of (start, end) intervals, in the same unit."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


def parse_only(logdir: str, steps: int) -> None:
    """Parse a trace dir: per (process, thread-line) totals and top ops of
    the device tracks, and the device's busy and idle share of the traced
    window. Thread lines in the xplane->perfetto conversion separate
    'XLA Modules' / 'XLA Ops' / etc., which NEST (summing across lines
    double-counts; the busy share takes the union)."""
    traces = sorted(
        glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"),
                  recursive=True),
        key=os.path.getmtime,
    )
    if not traces:
        print("[prof] no trace.json.gz under", logdir)
        return
    with gzip.open(traces[-1], "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    pid_names, tid_names = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e.get("pid")] = e.get("args", {}).get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_names[(e.get("pid"), e.get("tid"))] = (
                e.get("args", {}).get("name", "")
            )
    dev_pids = {p for p, n in pid_names.items() if "/device" in n.lower()}
    lines = defaultdict(lambda: defaultdict(float))
    spans = defaultdict(list)
    t_lo, t_hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t_lo = min(t_lo, e["ts"])
        t_hi = max(t_hi, e["ts"] + e["dur"])
        if e.get("pid") not in dev_pids:
            continue
        key = (e.get("pid"), e.get("tid"))
        lines[key][e.get("name", "?")] += e["dur"]
        spans[e.get("pid")].append((e["ts"], e["ts"] + e["dur"]))
    window = t_hi - t_lo
    if not dev_pids:
        print(f"[prof] no device track in {sorted(pid_names.values())}")
    for pid in sorted(spans):
        busy = _busy_us(spans[pid])
        print(f"[prof] {pid_names[pid]}: busy {busy/1e3/steps:.3f} ms/step "
              f"of a {window/1e3/steps:.3f} ms/step traced window, idle "
              f"share {1 - busy/window:.3f}")
    for key, by_name in sorted(
        lines.items(), key=lambda kv: -sum(kv[1].values())
    ):
        total = sum(by_name.values())
        pname = pid_names.get(key[0], key[0])
        tname = tid_names.get(key, key[1])
        print(f"--- {pname} / {tname}: {total/1e3/steps:.2f} ms/step")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
            print(f"  {us/1e3/steps:9.3f} ms/step  {name[:110]}")


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--parse":
        parse_only(sys.argv[2], int(os.environ.get("PBTE_PROF_STEPS", 3)))
        return
    import tempfile

    import jax

    from pbte.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from __graft_entry__ import _build_problem

    steps = int(os.environ.get("PBTE_PROF_STEPS", 3))
    nx = int(os.environ.get("PBTE_BENCH_NX", 16))
    solver = _build_problem(
        nx=nx, order=int(os.environ.get("PBTE_BENCH_ORDER", 2)),
        polar=int(os.environ.get("PBTE_BENCH_POLAR", 4)),
        azimuth=int(os.environ.get("PBTE_BENCH_AZIMUTH", 16)),
        nspec=int(os.environ.get("PBTE_BENCH_NSPEC", 20)),
        dtype=jnp.float32, geom="hex", dim=3,
        cache_policy=os.environ.get("PBTE_BENCH_POLICY", "eigen"),
    )
    u, Tc, Tv = solver.initial_state()
    u, Tc, Tv2, r = solver.step(u, Tc, Tv)
    jax.block_until_ready((u, Tc, Tv2, r))

    logdir = os.environ.get("PBTE_PROF_DIR") or tempfile.mkdtemp(
        prefix="pbte_prof_")
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time()
    with jax.profiler.trace(logdir):
        prev = Tv2
        for _ in range(steps):
            u, Tc, Tv2, r = solver.step(u, Tc, prev)
            prev = Tv2
        jax.block_until_ready((u, Tc, Tv2, r))
    wall = time.time() - t0
    print(f"[prof] trace in {logdir}; {steps} steps traced in {wall:.3f}s "
          f"({wall/steps*1e3:.1f} ms/step incl. trace overhead)",
          file=sys.stderr)

    parse_only(logdir, steps)


if __name__ == "__main__":
    main()
