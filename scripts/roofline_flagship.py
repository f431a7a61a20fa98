"""Memory roofline of the flagship ring step.

Settles whether the step is bound by memory traffic or by scheduling: in one
run it (a) measures this card's copy bandwidth and the rate of a plain bf16
matmul (pbte.device), (b) measures the flagship step time, (c) computes the
step's analytic memory traffic from the solver's actual slot/window/dtype
configuration, and reports achieved bytes/s as a fraction of the measured
copy bandwidth. Prints the card's name and power limit to stderr and one
JSON line to stdout.

Traffic model (per level-slot instance, per (k, b) ordinate-band pair,
lattice+folded ring with bf16 staging — the default flagship config):
  v_l read            D * state_bytes     (scan xs slice)
  ys write            D * state_bytes     (scan ys emit)
  xcat staging        J * 2 * 2           (bf16 write + dot read)
  ring carry          (nf_act + 1) * D * 2  (3 shifted reads + 1 write, bf16)
plus per (k, slot): cin nf_act*4 and bsrc D*4 reads; per slot: tc D*4;
plus the folded factor re-streamed per level: L * |bcat| bytes; plus the
in-scan macro partials (L, D, W) * 4 per group.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main() -> None:
    import jax

    from bench import card
    from pbte.device import copy_bandwidth, enable_compile_cache, matmul_rate

    enable_compile_cache()

    from __graft_entry__ import _build_problem

    # ---- (a) copy bandwidth and matmul rate of this card ------------------
    bw = copy_bandwidth(int(os.environ.get("PBTE_ROOF_COPY_MB", 1024)))
    mm = matmul_rate("bfloat16")
    print(f"[roofline] card: {card()}; copy bandwidth {bw/1e9:.0f} GB/s, "
          f"bf16 matmul {mm/1e12:.0f} TF/s", file=sys.stderr)

    # ---- (b) flagship step time -----------------------------------------
    nx = int(os.environ.get("PBTE_BENCH_NX", 16))
    solver = _build_problem(nx=nx, order=2, polar=4, azimuth=16, nspec=20)
    assert solver.sweep_mode == "ring" and solver._ring_lattice
    u, Tc, Tv = solver.initial_state()
    u, Tc, Tv2, r = solver.step(u, Tc, Tv)
    jax.block_until_ready((u, Tc, Tv2, r))
    steps = 10
    t0 = time.time()
    prev = Tv2
    for _ in range(steps):
        u, Tc, Tv2, r = solver.step(u, Tc, prev)
        prev = Tv2
    jax.block_until_ready((u, Tc, Tv2, r))
    dt = (time.time() - t0) / steps
    print(f"[roofline] step time: {dt*1e3:.1f} ms", file=sys.stderr)

    # ---- (c) analytic memory traffic ------------------------------------
    D, BS, L = solver.D, solver.BS, solver.L
    nf_act = solver._ring_nf_act
    J = (1 + nf_act) * D
    st = 2 if solver._ring_stage_bf16 else 4
    sb = 2 if solver._ring_state_bf16 else 4
    # windowed slot count (slots touched per group per step)
    if solver._ring_windowed:
        slot_tot = sum(
            (l1 - l0) * Ws for l0, l1, _, _, Ws in solver._ring_segs
        )
    else:
        slot_tot = L * solver.W
    inst = 0  # (group-slot, k, b) slot instances
    kslots = 0
    gW = 0
    for gs, km_b in solver._ring_buckets:
        inst += len(gs) * km_b * BS * slot_tot
        kslots += len(gs) * km_b * slot_tot
        gW += len(gs) * slot_tot
    comp = {
        "v_read": inst * D * sb,
        "ys_write": inst * D * sb,
        "xcat_staging": inst * J * st * 2,
        "ring_carry": inst * (nf_act + 1) * D * st,
        "cin_bsrc": kslots * (nf_act * 4 + D * 4),
        "tc_slab": gW * D * 4,
        # the folded factor is re-streamed from memory at every level
        "bcat_stream": L * sum(
            len(gs) * km_b * BS * D * J * st
            for gs, km_b in solver._ring_buckets
        ),
        "macro_partials": gW * D * 4,
    }
    total = sum(comp.values())
    ach = total / dt
    dev = jax.devices()[0]
    print(f"[roofline] analytic {total/1e9:.1f} GB/step -> "
          f"{ach/1e9:.0f} GB/s achieved = {ach/bw:.1%} of copy bandwidth",
          file=sys.stderr)
    print(json.dumps({
        "metric": "flagship_step_memory_fraction",
        "value": ach / bw,
        "unit": "fraction_of_measured_copy_bw",
        "copy_bw_gbs": bw / 1e9,
        "bf16_matmul_tfs": mm / 1e12,
        "step_ms": dt * 1e3,
        "analytic_bytes_per_step": total,
        "achieved_gbs": ach / 1e9,
        "components_gb": {k: v / 1e9 for k, v in comp.items()},
        "shape": {"nx": nx, "D": D, "BS": BS, "L": L, "J": J,
                  "slot_tot": slot_tot, "stage_bytes": st,
                  "state_bytes": sb},
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }))


if __name__ == "__main__":
    main()
