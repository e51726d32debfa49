#!/usr/bin/env python3
"""Route (b) of the batched fallback (the lane-batched plain blocked loop)
against the single-LP plain blocked loop on config 3's lanes, on the card.

Config 3's 256 problems (2,000 variables x 500 constraints, seeds
1000..1255); the lanes 0, 5, .., 255 with 85 and 170. One of four modes,
each one JSON line of the (phase 1, phase 2) pivots a lane, for the mixed
options (f32 tableau, f64 vectors, eps 1e-5, L=32, ``kernel=False``) and
the f64 blocked ones (L=32):

* ``batch256``: route (b) over all 256 lanes (the lanes' walks read out);
* ``batch55``: route (b) over the 55 lanes alone (a lane's walk should not
  hang on the batch's width);
* ``single``: each lane through ``solve(..., use_pallas=False)``, the
  single-LP plain blocked loop;
* ``old``: the same with the loop's old body
  (``solver.solve_loop_blocked_reference``: about 30 torch calls a
  pivot, its eta corrections ``@`` products in the tableau's dtype).

Run from a checkout (``ROOT`` the checkout to import, ``.`` by default)::

    python3 tools/blocked_lanes.py ROOT MODE
"""

import json
import sys
import time

root = sys.argv[1] if len(sys.argv) > 1 else "."
mode = sys.argv[2] if len(sys.argv) > 2 else "single"
sys.path.insert(0, root)
import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
import simplex_tpu_torch as st  # noqa: E402
from simplex_tpu_torch import solver  # noqa: E402

MIXED = dict(dtype="float32", vector_dtype="float64", eps=1e-5,
             block_pivots=32)
F64 = dict(dtype="float64", block_pivots=32)
LANES = sorted(set(list(range(0, 256, 5)) + [85, 170, 255]))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("blocked_lanes: needs a CUDA card")
    probs = [st.generate_random_problem(2000, 500, 1000 + s, 1, 100)
             for s in range(256)]
    out = {}
    t0 = time.perf_counter()
    for label, opts in (("mixed", MIXED), ("f64", F64)):
        kern = False if label == "mixed" else "auto"
        if mode == "batch256":
            res = st.solve_batch(probs, device="cuda", kernel=kern, **opts)
            out[label] = {i: (res[i].iterations_phase1,
                              res[i].iterations_phase2) for i in LANES}
        elif mode == "batch55":
            res = st.solve_batch([probs[i] for i in LANES], device="cuda",
                                 kernel=kern, **opts)
            out[label] = {i: (r.iterations_phase1, r.iterations_phase2)
                          for i, r in zip(LANES, res)}
        else:
            if mode == "old":
                solver.solve_loop_blocked = (
                    lambda tab, o, cap, costs0=None, **kw:
                    solver.solve_loop_blocked_reference(tab, o, cap, costs0))
            out[label] = {}
            for i in LANES:
                r = st.solve(probs[i], device="cuda", use_pallas=False,
                             **opts)
                out[label][i] = (r.iterations_phase1, r.iterations_phase2)
    print(json.dumps({"root": root, "mode": mode,
                      "card": torch.cuda.get_device_name(0),
                      "s": time.perf_counter() - t0, "walks": out}))


if __name__ == "__main__":
    main()
