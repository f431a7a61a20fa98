"""Rate of the batched sweep contraction against this card's measured peak.

Whole-step throughput (bench.py) also pays the per-level streaming of the
state, so this isolates the KERNEL: the folded transport matmul
``sol = [B | -vg*B*C_f] @ [rhs; un_f]`` exactly as the ring body emits it
(pbte/solver/source_iteration.py, the ``kbiJ,kJbw->kibw`` einsum),
including its real per-level staging — the shifted-carry reads, the bf16
xcat concatenation, and the carry update.

Chained inside ONE lax.scan per jit call, so per-call dispatch does not
swamp sub-millisecond levels. Each level's input is the previous level's
output, like the real sweep.

Modes (PBTE_KMFU_MODE):
  staged  — full per-level staging as in the solver body (default)
  pure    — the bare matmul with a carried xcat (isolates the dot's rate)

Shapes default to the flagship ring level (Km=8 direction slots, BS=40
bands, D=27 p=2 dofs, J=(1+3)*D folded contraction, W=256 slots);
PBTE_KMFU_ORDER=3 switches to the p=3 kernel (D=64, J=256).

The same run measures what a large plain bf16 matrix product and a large
copy reach on this card (pbte.device.matmul_rate / copy_bandwidth) and
reports the kernel's rate as a share of that bf16 rate. Prints the card's
name and power limit to stderr and one JSON line to stdout.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    from bench import card
    from pbte.device import copy_bandwidth, enable_compile_cache, matmul_rate

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    mode = os.environ.get("PBTE_KMFU_MODE", "staged")
    order = int(os.environ.get("PBTE_KMFU_ORDER", 2))
    D = (order + 1) ** 3
    Km = int(os.environ.get("PBTE_KMFU_KM", 8))
    BS = int(os.environ.get("PBTE_KMFU_BS", 40))
    W = int(os.environ.get("PBTE_KMFU_W", 256))
    nf_act = 3  # active upwind faces per direction group on a 3D lattice
    J = (1 + nf_act) * D
    levels = int(os.environ.get("PBTE_KMFU_LEVELS", 2000))
    shifts = (0, 1, 16)  # the three lattice strides at hex-16^3

    rng = np.random.default_rng(0)
    bcat = jnp.asarray(
        rng.standard_normal((Km, BS, D, J)) / np.sqrt(J), jnp.bfloat16
    )
    ring0 = jnp.asarray(rng.standard_normal((Km, D, BS, W)), jnp.bfloat16)
    cin = jnp.asarray(rng.uniform(0.4, 0.6, (nf_act, Km, W)), jnp.float32)
    rhs0 = jnp.asarray(rng.standard_normal((Km, D, BS, W)), jnp.bfloat16)
    xcat0 = jnp.asarray(rng.standard_normal((Km, J, BS, W)), jnp.bfloat16)

    if mode == "staged":

        def body(ring, _):
            # mirror of the solver body: rhs is a cheap elementwise
            # expression there; here a carried tensor stands in (same
            # memory read) and the three
            # shifted reads + bf16 concat + folded matmul are identical
            parts = [rhs0]
            for fi, s in enumerate(shifts):
                yf = ring
                if s:
                    yf = jnp.pad(
                        yf[..., :-s], ((0, 0), (0, 0), (0, 0), (s, 0))
                    )
                parts.append(
                    (yf * cin[fi][:, None, None, :]).astype(jnp.bfloat16)
                )
            xcat = jnp.concatenate(parts, axis=1)
            sol = jnp.einsum(
                "kbiJ,kJbw->kibw", bcat, xcat,
                preferred_element_type=jnp.float32,
            )
            return sol.astype(jnp.bfloat16), None

        carry0 = ring0
    elif mode == "pure":

        def body(xcat, _):
            sol = jnp.einsum(
                "kbiJ,kJbw->kibw", bcat, xcat,
                preferred_element_type=jnp.float32,
            )
            # feed the output back as the next xcat (tile D -> J) so levels
            # stay data-dependent; the tile is a cheap broadcast
            nxt = jnp.concatenate([sol] * (J // D), axis=1)
            return nxt.astype(jnp.bfloat16), None

        carry0 = xcat0
    else:
        raise SystemExit(f"unknown PBTE_KMFU_MODE={mode}")

    @jax.jit
    def chain(c):
        c, _ = lax.scan(body, c, None, length=levels)
        return c[0, 0, 0, 0]

    t0 = time.time()
    jax.block_until_ready(chain(carry0))
    dev = jax.devices()[0]
    print(f"[kmfu] compile+first: {time.time()-t0:.1f}s "
          f"mode={mode} D={D} J={J} Km={Km} BS={BS} W={W} levels={levels} "
          f"device={dev.device_kind}; card: {card()}", file=sys.stderr)

    reps = int(os.environ.get("PBTE_KMFU_REPS", 3))
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(chain(carry0))
        best = min(best, time.time() - t0)
    flops = 2.0 * Km * BS * D * J * W * levels
    tf = flops / best / 1e12
    peak = matmul_rate("bfloat16") / 1e12
    bw = copy_bandwidth() / 1e9
    print(f"[kmfu] best {best*1e3:.1f} ms for {levels} levels "
          f"({flops/levels/1e9:.3f} GF/level) at {tf:.1f} TF/s = "
          f"{tf/peak:.1%} of the {peak:.0f} TF/s a plain bf16 matmul "
          f"reaches here (copy {bw:.0f} GB/s)", file=sys.stderr)
    print(json.dumps({
        "metric": "sweep_kernel_tf_per_s",
        "value": tf,
        "unit": "TF/s",
        "mode": mode,
        "order": order,
        "shape": {"Km": Km, "D": D, "J": J, "BS": BS, "W": W},
        "measured_bf16_matmul_tf_per_s": peak,
        "frac_measured_bf16_matmul": tf / peak,
        "measured_copy_gb_per_s": bw,
        "best_ms": best * 1e3,
        "levels": levels,
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }))


if __name__ == "__main__":
    main()
