"""Compare converged flagship fields across matmul precisions.

Reads converge_flagship_{default,high,selective}.npz (written by
scripts/converge_flagship.py) against converge_flagship_highest.npz (the
full-f32 reference) and writes the precision-tier table
field_precision_delta.txt: relative L2 / max field bias of each tier's
converged solution — the per-step operand rounding amplified ~1/(1-rho)
into the fixed point."""
import os

import numpy as np

d = os.path.dirname(os.path.abspath(__file__))
ref = np.load(os.path.join(d, "converge_flagship_highest.npz"))["Tc"]
rows = []
for tier in ("default", "high", "selective"):
    path = os.path.join(d, f"converge_flagship_{tier}.npz")
    if not os.path.exists(path):
        continue
    a = np.load(path)["Tc"]
    l2 = np.linalg.norm(a - ref) / np.linalg.norm(ref)
    mx = np.abs(a - ref).max() / np.abs(ref).max()
    rows.append((tier, l2, mx))
    print(f"{tier:10s} vs highest: rel_l2 {l2:.3e}  rel_max {mx:.3e}")
with open(os.path.join(d, "field_precision_delta.txt"), "w") as f:
    f.write("# tier rel_l2 rel_max (vs matmul_precision=highest)\n")
    for tier, l2, mx in rows:
        f.write(f"{tier} {l2:.6e} {mx:.6e}\n")
