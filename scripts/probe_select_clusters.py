"""Probe of the K5 kernel (threshold top-k, ``csrc/select_kernel.cu``) on a
CUDA card: not part of the port's main path or of ``chip_smoke.py``.

    python3 scripts/probe_select_clusters.py

1. Sweeps row shapes (multiples of 4 and not, shorter than the cluster,
   longer than a block's shared memory, B = 1), value patterns (uniform,
   grids of ties, three values scattered and in runs, one value, NaN of both
   signs, +-inf, -0.0) and k (1 .. S) over cluster sizes 8, 16, 1 and 3, and
   holds indices and value bits equal to ``topk_threshold_reference``.
2. Times the main-path rows for cluster sizes 8, 16 and 4 beside the wrapper
   and ``torch.topk`` (median of 20, CUDA events), which is how the cluster
   size of ``select_plan`` was chosen.
Exits non-zero on any mismatch.
"""
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda import select_kernel as sk

dev = torch.device("cuda", 0)
build.library()

def run(scores, k, cluster):
    b, s = scores.shape
    plan = sk.select_plan(s, cluster)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    build.launch("frcnn_topk_threshold", scores.data_ptr(), b, s, k, plan["cluster"],
                 plan["segment"], plan["smem_floats"], vals.data_ptr(), idx.data_ptr())
    return vals, idx

def same(name, scores, k, cluster):
    kv, ki = run(scores, k, cluster)
    tv, ti = sk.topk_threshold_reference(scores, k)
    torch.cuda.synchronize()
    ok = torch.equal(ki, ti) and torch.equal(kv.view(torch.int32), tv.view(torch.int32))
    if not ok:
        print(f"MISMATCH {name} S={scores.shape} k={k} cluster={cluster}: {(ki != ti).sum().item()} of {ki.numel()}")
    return ok

rng = np.random.RandomState(0)
bad = 0
n_cases = 0
for cluster in (8, 16, 1, 3):
    for (b, s) in ((8, 21888), (8, 182400), (8, 45600), (8, 155520), (8, 116736), (1, 182400),
                   (3, 50), (2, 5), (2, 4001), (2, 4002), (1, 500000), (3, 16385)):
        rows = {
            "uniform": rng.uniform(0, 1, (b, s)).astype(np.float32),
            "grid": (np.round(rng.uniform(0, 1, (b, s)) * 64) / 64).astype(np.float32),
            "three": rng.randint(0, 3, (b, s)).astype(np.float32),
            "const": np.full((b, s), 7.0, np.float32),
            "normal": rng.randn(b, s).astype(np.float32),
        }
        blocks = np.sort(rng.randint(0, 3, (b, s)), axis=1)[:, ::-1].astype(np.float32)  # runs 2..,1..,0..
        rows["runs"] = np.ascontiguousarray(blocks)
        hard = rng.randint(-3, 4, (b, s)).astype(np.float32)
        hard[0, ::7] = np.nan
        hard[0, 3 % s] = np.float32(np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0])
        hard[-1, ::5] = np.inf
        hard[-1, 1::5] = -np.inf
        hard[-1, 2::5] = -0.0
        rows["hard"] = hard
        for name, arr in rows.items():
            tens = torch.from_numpy(arr).to(dev)
            for k in sorted({1, 2, min(s, 128), min(s, 1000), s // 2, s - 1, s}):
                if k < 1:
                    continue
                n_cases += 1
                bad += not same(name, tens, k, cluster)
print(f"cases {n_cases}, mismatches {bad}")

def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); e.record(); e.synchronize(); ts.append(a.elapsed_time(e))
    return statistics.median(ts)

for (b, s, k) in ((8, 21888, 128), (8, 21888, 256), (8, 182400, 1000), (8, 45600, 1000),
                  (8, 155520, 128), (8, 155520, 256), (8, 116736, 2000), (1, 182400, 1000)):
    x = torch.from_numpy(rng.uniform(0, 1, (b, s)).astype(np.float32)).to(dev)
    line = f"({b},{s}) k {k}:"
    for cluster in (8, 16, 4):
        line += f" cluster {cluster} {cuda_ms(lambda: run(x, k, cluster)):.4f} ms;"
    line += f" wrapper {cuda_ms(lambda: sk.topk_threshold(x, k)):.4f}; topk {cuda_ms(lambda: torch.topk(x, k, dim=1)):.4f}"
    print(line)
print("bad", bad)
sys.exit(1 if bad else 0)
