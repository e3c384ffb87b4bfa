"""Timing ablations of the K3 kernel (``csrc/fused_block.cu``) on a CUDA card:
which part of the fused bottleneck sets its time.  Not part of the port's
main path or of ``chip_smoke.py``.

    python3 scripts/ablate_fused_block.py [variant ...]     # default: every variant

For each variant the package is copied under the system's temp directory
with one part of ``fused_block.cu`` switched off (the copies of x, w1, w2 or
w3 into shared memory, each conv's products, conv3's epilogue, the residual
loads; also a ring of 2 or 4 stages in place of 3), built there, and timed
at the layer2 (8x100x152x512, mid 128) and layer1 (8x200x304x256, mid 64)
identity blocks: median of 5 runs of 10 back-to-back launches between two
CUDA events.  The variants' OUTPUTS ARE
WRONG by construction: only their times are read.  The repository's own
sources are not touched.
"""
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = open(os.path.join(ROOT, "frcnn_tpu_torch/csrc/fused_block.cu")).read()
WRAPPER = open(os.path.join(ROOT, "frcnn_tpu_torch/ops/cuda/fused_block.py")).read()

W2_LOAD = "      stage_weights<MID>(ring + buf * L::stage2, w2, MID, s * kK2, 0, kK2, 9 * MID);"
X_LOAD = "      stage_pixels(dst, xb, kM1, r0 - 1, c0 - 1, h, w, cin, s * kKC);"
W1_LOAD = "      stage_weights<MID>(dst + L::a1_bytes, w1, MID, s * kKC, 0, kKC, cin);"
W3_LOAD = "        stage_weights<kPanel>(dst, w3, cout, 0, p * kPanel, MID, MID);"
MMA1 = "            Wgmma<kNH>::run(acc1[i], da, db, (s | kk) != 0);"
MMA2 = "        Wgmma<MID>::run(acc2, da, db, (s | kk) != 0);"
MMA3 = "          Wgmma<kPanel>::run(acc3, da, db, kk != 0);"
EPI3 = "      if (j != steps_per_panel - 1) return;"
RES = "            res[hh][g] = valid ? *reinterpret_cast<const __nv_bfloat162*>(xrow + g * 8)"
STAGES_CU = "constexpr int kStages = 3;"
STAGES_PY = "PANEL, STAGES = 32, 64, 64, 3"
assert WRAPPER.count(STAGES_PY) == 1
for needle in (STAGES_CU, W2_LOAD, X_LOAD, W1_LOAD, W3_LOAD, MMA1, MMA2, MMA3, EPI3, RES):
    assert SRC.count(needle) == 1, needle

def off(line):
    return (line, "      if (h < 0) { " + line.strip() + " }")

VARIANTS = {
    "baseline": [],
    "no_w2_loads": [off(W2_LOAD)],
    "no_x_loads": [off(X_LOAD)],
    "no_w1_loads": [off(W1_LOAD)],
    "no_w3_loads": [off(W3_LOAD)],
    "no_loads": [off(W2_LOAD), off(X_LOAD), off(W1_LOAD), off(W3_LOAD)],
    "no_mma1": [off(MMA1)],
    "no_mma2": [off(MMA2)],
    "no_mma3": [off(MMA3)],
    "no_mma": [off(MMA1), off(MMA2), off(MMA3)],
    "no_epilogue3": [(EPI3, "      if (j != steps_per_panel - 1 || h > 0) return;")],
    "no_residual": [(RES, "            res[hh][g] = (valid && h < 0) ? *reinterpret_cast<const __nv_bfloat162*>(xrow + g * 8)")],
    "no_loads_no_mma": [off(W2_LOAD), off(X_LOAD), off(W1_LOAD), off(W3_LOAD), off(MMA1), off(MMA2), off(MMA3)],
    "stages_2": [(STAGES_CU, STAGES_CU.replace("3", "2"))],
    "stages_4": [(STAGES_CU, STAGES_CU.replace("3", "4"))],
}

TIMER = r'''
import sys, statistics, torch
from frcnn_tpu_torch.ops.cuda.fused_block import fused_bottleneck
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(0)
def r(*s, std=1.0):
    return (torch.randn(s, generator=g) * std).to(dev, torch.bfloat16)
out = []
for h, w, cin, mid in ((100, 152, 512, 128), (200, 304, 256, 64)):
    cout = 4 * mid
    x = torch.relu(r(8, h, w, cin))
    wts = [r(cin, mid, std=(2 / cin) ** 0.5), r(mid, std=0.1), r(9 * mid, mid, std=(2 / (9 * mid)) ** 0.5),
           r(mid, std=0.1), r(mid, cout, std=mid ** -0.5), r(cout, std=0.1)]
    for _ in range(3): fused_bottleneck(x, *wts)
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10): fused_bottleneck(x, *wts)
        e.record(); e.synchronize(); ts.append(a.elapsed_time(e) / 10)
    out.append(f"mid {mid}: {statistics.median(ts):.4f} ms")
print(sys.argv[1], "; ".join(out), flush=True)
'''

for name in sys.argv[1:] or VARIANTS:
    edits = VARIANTS[name]
    dst = os.path.join(tempfile.gettempdir(), f"ablate_fused_block_{name}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "frcnn_tpu_torch"), os.path.join(dst, "frcnn_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    text = SRC
    for old, new in edits:
        text = text.replace(old, new)
    with open(os.path.join(dst, "frcnn_tpu_torch/csrc/fused_block.cu"), "w") as f:
        f.write(text)
    if name.startswith("stages_"):      # the wrapper's plan must be the kernel's layout
        with open(os.path.join(dst, "frcnn_tpu_torch/ops/cuda/fused_block.py"), "w") as f:
            f.write(WRAPPER.replace(STAGES_PY, STAGES_PY[:-1] + name[-1]))
    res = subprocess.run([sys.executable, "-c", TIMER, name], cwd=dst, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": dst})
    print(res.stdout.strip() or res.stderr[-1500:], flush=True)
