"""Which PyTorch calls of the vision path a CUDA graph can capture.

The hybrid mission's vision fix runs inside 100-step CUDA graphs, where a
call that reads the card from the host (a solver's status check, a copy
from pageable memory) makes the capture fail. For each candidate this
captures one call on small batched inputs, in a process of its own (a
failed capture leaves PyTorch's graph pool recording), and prints one JSON
line: "captures", or the last line of the error. Needs a CUDA card:

    python scripts/capture_probe.py
"""

import json
import subprocess
import sys

CALLS = {
    "eigh": "torch.linalg.eigh(a9)[1]",
    "svd": "torch.linalg.svd(a3)[0]",
    "det": "torch.linalg.det(a3)",
    "solve": "torch.linalg.solve(a6, b6)",
    "solve_ex": "torch.linalg.solve_ex(a6, b6, check_errors=False)[0]",
    "cholesky_ex": "torch.linalg.cholesky_ex(a6)[0]",
    "lu_factor_ex": "torch.linalg.lu_factor_ex(a6)[0]",
    "topk_int64": "torch.topk(k64, 54, dim=1)[1]",
    "argsort_stable": "torch.argsort(f, dim=1, stable=True)",
}

CAPTURE = """
import torch
torch.manual_seed(0)
d = "cuda"
m = torch.randn(14, 9, 9, device=d); a9 = m @ m.transpose(1, 2)
a3 = torch.randn(14, 3, 3, device=d)
m6 = torch.randn(14, 6, 6, device=d)
a6 = m6 @ m6.transpose(1, 2) + torch.eye(6, device=d); b6 = torch.randn(14, 6, 1, device=d)
k64 = torch.randint(0, 2**40, (14, 230400), device=d)
f = torch.randn(14, 54, device=d)
s = torch.cuda.Stream(); s.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(s):
    for _ in range(2):
        y = CALL
torch.cuda.current_stream().wait_stream(s)
g = torch.cuda.CUDAGraph()
with torch.cuda.graph(g):
    y = CALL
g.replay()
torch.cuda.synchronize()
print("CAPTURED")
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("capture_probe: no CUDA device is available", file=sys.stderr)
        return 1
    out = {}
    for name, call in CALLS.items():
        proc = subprocess.run([sys.executable, "-c", CAPTURE.replace("CALL", call)],
                              capture_output=True, text=True, timeout=300)
        if "CAPTURED" in proc.stdout:
            out[name] = "captures"
        else:
            out[name] = (proc.stderr.strip().splitlines() or ["no output"])[-1][:200]
    print(json.dumps({"capture": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
