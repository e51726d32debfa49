"""Run ``chip_smoke.py``'s checkpointed-solve phase alone on one CUDA
card: build the kernels, then ``phase_resumable`` (its warm-median
comparison left out, printed as nan). A short call to try a change to
that phase before the whole script::

    python3 tools/resumable_probe.py
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from simplex_tpu_torch.kernels import _build  # noqa: E402

if __name__ == "__main__":
    print(cs.nvidia_smi_line(), torch.__version__, torch.version.cuda,
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.load_library()
    t0 = time.perf_counter()
    try:
        cs.phase_resumable(float("nan"))
    except cs.SmokeFailure as e:
        print("FAILED:", e)
        sys.exit(1)
    print(f"phase_resumable passed in {time.perf_counter() - t0:.1f} s")
