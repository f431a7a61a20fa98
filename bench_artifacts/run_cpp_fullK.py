"""Record the FULL-K C++ baseline artifact.

One outer iteration of the native reference-mirror solver
(pbte/native/solver_native.cpp) on the flagship shape — hex 16^3,
p=2 (D=27), the full 4x16 = 64-direction product quadrature, 2x20 bands —
validating bench.py's 8-direction-subset extrapolation with a measured
full-K artifact. Writes cpp_fullK.txt next to this script."""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from pbte import mesh as pmesh
from pbte import native
from pbte.angular import quadrature as ang
from pbte.fem import assembly
from pbte.material import nongray_smrt as mat

m = pmesh.make_cartesian_3d(16, 16, 16, "hex").scaled(1e-6)
ops = assembly.assemble(pmesh.connect(m), order=2, face_mode="consistent")
quad = ang.build(ang.AngularOptions(dimension=3, polar_points=4,
                                    azimuth_points=16))
tables = mat.build_tables(mat.SILICON, num_spectral=20)
bcs = {a: (0.5 if a == 6 else -0.5) for a in range(1, 7)}
t0 = time.time()
out = native.cpp_source_iteration(ops, quad, tables, bcs, 1, use_full_lu=False)
assert out is not None, "native toolchain unavailable"
*rest, secs = out
dt = float(np.sum(secs))
K, BS = quad.num_directions, 40
ne, D = ops.num_elements, ops.ndof
dofs = K * BS * ne * D / dt
rec = {
    "shape": {"ne": ne, "D": D, "K": K, "BS": BS},
    "iters": 1,
    "seconds_per_iter": dt,
    "dof_per_s": dofs,
    "host": os.uname().nodename,
    "total_wall_s": time.time() - t0,
}
path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp_fullK.txt")
with open(path, "w") as f:
    f.write("# Full-K C++ baseline (native/solver_native.cpp), flagship shape\n")
    f.write(json.dumps(rec, indent=2) + "\n")
print(json.dumps(rec))
