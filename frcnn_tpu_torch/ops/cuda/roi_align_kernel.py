"""K2: batched RoIAlign forward, K2b: its backward, K6: the multilevel (FPN)
RoIAlign forward, K6b: its backward — CUDA kernel wrappers, their plain
twins, and the autograd Functions that join each forward to its backward
(``RoIAlignFunction``: K2 and K2b; ``RoIAlignMultilevelFunction``: K6 and
K6b).

Replaces the TPU kernels ``frcnn_tpu/ops/pallas/roi_align_kernel.py``
(``roi_align_pallas`` / ``_fwd_kernel``, its custom VJP ``_bwd_rule`` /
``_bwd_kernel``, the per-level FPN forwards ``roi_align_level_fwd`` /
``_fwd_kernel_lv`` and ``roi_align_levels_fwd_merged`` / ``_fwd_kernel_ml``,
and the per-level FPN backward ``roi_align_level_bwd`` / ``_bwd_kernel_lv``).
The TPU kernels phrased bilinear sampling as interpolation matmuls for its
matrix unit; the kernels (``frcnn_tpu_torch/csrc/roi_align_kernel.cu``)
gather instead.  K2 takes one block per (image, roi, chunk of channels): it
computes the roi's 2 * p * sr sample geometries once, stages the distinct
map rows x columns they touch in shared memory with 16-byte copies
(channels-last: a pixel's chunk is contiguous), pools every bin from there
and writes 16 bytes of channels a thread.  Bound on the H100: by the count
memory traffic (the B*R*p*p*C output written once, the pixels under a roi
read once); in fact the SMs' arithmetic rate (16 corner reads from shared
memory and 28 multiply-adds an output value, in the order that keeps its
bits).
``roi_plan`` is the launch geometry: channels a block, threads, staging
bytes; ``staged_pixels`` counts the pixels a run's rois stage.

K2b (same source) is the gather form of the adjoint: a block owns a tile of
dF (pixels of one level of one image, a chunk of channels), walks the
image's rois in index order, keeps those whose samples may reach the tile,
stages their dOut bins that reach it in shared memory, and each thread adds,
for its own channels of its own pixels, Ay * (sum over bin columns of Ax *
dOut) over the bins that reach the pixel into f32 sums in its registers,
then rounds once to the gradient dtype.  No atomics, no f32
scratch, no memset or rounding pass: one launch writes dF, and the fixed
order of the adds makes it bit-deterministic.  Rois get no gradient.
``roi_bwd_plan`` is its launch geometry: tile, channel chunk, threads, kept
rois whose geometry a block holds, staged bins, and the shared memory they
take.

K6 (same source) pools every roi from its own pyramid level in one launch
over all levels, in roi order; the levels' base pointers, sizes and scales
are launch arguments, so the maps are never concatenated.  It shares K2's
sample geometry, staging and interpolation code, so on one level the two
agree bit for bit.

K6b (same source) is K2b's kernel over the tiles of every level in one
launch, each tile keeping only the rois of its own level; the levels' dF lie
end to end in one buffer; every level gets a dense gradient, all zeros where
no roi was assigned to it; rois and levels get none.  The sum order does not
depend on the tile, so on one level K6b equals K2b bit for bit.  Bound on
the H100, by the count: memory traffic, dF written once and dOut read once;
in fact K2b and K6b are bound by the latency of their rounds on the tiles
that the most rois reach.

``roi_align_reference`` is the plain twin of K2: the same gather in PyTorch
ops, f32 accumulation (f64 for f64 features), result in the feature dtype.
``roi_align_backward_reference`` is the plain twin of K2b: ``index_add_``
of the same sample weights into an f32 buffer (f64 for f64), then a cast.
It is not autograd of the forward twin, which in bf16 would accumulate in
bf16.  ``roi_align_multilevel_reference`` is the plain twin of K6: K2's twin
on every level, each roi's row taken from its own level.
``roi_align_multilevel_backward_reference`` is the plain twin of K6b: K2b's
twin on every level, with the gradient rows of the other levels' rois zeroed.
"""

from __future__ import annotations

import ctypes

import torch

from frcnn_tpu_torch.ops.constants import device_constant
from frcnn_tpu_torch.ops.cuda import build


def _axis_samples(lo, hi, p: int, sr: int, size: int):
    """Sample geometry along one axis, as ``frcnn_tpu/ops/roi_align.py``:
    lo/hi (B, R) scaled roi edges → (low, high) indices and their weights,
    each (B, R, p*sr); an empty sample gets zero weights."""
    # divide by tensors: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the correctly rounded quotient
    p_t, sr_t = (device_constant(float(v), torch.get_default_dtype(), lo.device) for v in (p, sr))
    bin_sz = torch.clamp(hi - lo, min=1.0) / p_t
    s = (torch.arange(p * sr, dtype=torch.float32, device=lo.device) + 0.5) / sr_t
    coords = lo[..., None] + s * bin_sz[..., None]
    empty = (coords < -1.0) | (coords > size)
    c = torch.clamp(coords, 0.0, size - 1.0)
    low = torch.floor(c)
    frac = c - low
    low_i = low.long()
    high_i = torch.clamp(low_i + 1, max=size - 1)
    w_lo = torch.where(empty, 0.0, 1.0 - frac)
    w_hi = torch.where(empty, 0.0, frac)
    return low_i, high_i, w_lo, w_hi


_CHUNK = 64  # rois per step of the twins: bounds their gathered intermediates

STAGE_BYTES = 40 * 1024      # shared memory a forward block stages pixels in
CHUNK_CHANNELS = 256         # channels of a roi that one block pools
FORWARD_THREADS = 128
MAX_SAMPLES = 32             # p * sr an axis, at most
GEOMETRY_SMEM_BYTES = 4 * MAX_SAMPLES * 8 + 2 * 2 * MAX_SAMPLES * 4 + 8   # RoiGeometry


BWD_TILE = (8, 8)            # dF pixels (rows, columns) that one backward block owns
BWD_CHUNK_CHANNELS = 128     # channels of them
BWD_THREADS = 256
BWD_BATCH = 8                # kept rois whose geometry a backward block holds at once
BWD_STAGE_BINS = 168         # dOut bins a backward round stages (a roi has p * p)
BWD_PAIRS = 4                # (pixel, vec channels) sums a backward thread holds
MAX_BLOCK_SMEM = 232448      # shared memory a block may take on the H100


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def roi_bwd_smem_bytes(element_size: int, tile_h: int, tile_w: int, chunk: int,
                       output_size: int, sampling_ratio: int, batch: int, stage_bins: int,
                       threads: int) -> int:
    """Shared memory of a K2b/K6b block (``bwd_layout`` in the source): the
    staged dOut bins, then for a round's kept rois their
    samples (two ints and two floats an axis sample), a weight a bin and
    tile row or column, a bit mask a tile row or column and a rectangle of
    staged bins a roi, then the kept list (an index and four coordinates a
    roi), a count a warp and two more."""
    ns, edge = output_size * sampling_ratio, tile_h + tile_w
    return (_align16(stage_bins * chunk * element_size)
            + 2 * _align16(batch * 2 * ns * 8) + _align16(batch * edge * output_size * 4)
            + _align16(batch * edge * 4) + _align16(batch * 16) + _align16(threads * 4)
            + threads * 16 + _align16(34 * 4))


def roi_bwd_plan(c: int, element_size: int, output_size: int = 7, sampling_ratio: int = 2,
                 tile=BWD_TILE, chunk: int = BWD_CHUNK_CHANNELS, threads: int = BWD_THREADS,
                 batch: int = BWD_BATCH, stage_bins: int = BWD_STAGE_BINS) -> dict:
    """Launch geometry of the backward kernels (K2b, K6b) for gradients of
    ``c`` channels of ``element_size`` bytes: ``vec`` channels a thread (16
    bytes' worth where a pixel's channels are a multiple of 16 bytes, else
    1), the dF ``tile_h`` x ``tile_w`` pixels and ``chunk`` channels a block
    owns (at most ``chunk``, and at most what BWD_PAIRS sums a thread hold),
    ``threads`` a block, ``batch`` kept rois whose geometry a block holds at
    once (at most 32), ``stage_bins`` dOut bins a round stages (at least
    p * p), and ``smem_bytes``, which the launcher requires to be its
    layout's."""
    vec = 16 // element_size
    if c % vec:
        vec = 1
    ns = output_size * sampling_ratio
    if ns > MAX_SAMPLES:
        raise ValueError(f"roi_align backward: {ns} samples an axis, the kernel takes "
                         f"{MAX_SAMPLES}")
    tile_h, tile_w = tile
    most = BWD_PAIRS * threads // (tile_h * tile_w) * vec   # channels the threads' sums hold
    if most < vec:
        raise ValueError(f"roi_align backward: {tile_h}x{tile_w} pixels for {threads} threads")
    chunk = max(vec, min(c, chunk, most) // vec * vec)
    stage_bins = max(stage_bins, output_size * output_size)
    smem = roi_bwd_smem_bytes(element_size, tile_h, tile_w, chunk, output_size, sampling_ratio,
                              batch, stage_bins, threads)
    if smem > MAX_BLOCK_SMEM:
        raise ValueError(f"roi_align backward: a plan of {smem} bytes of shared memory")
    return {"vec": vec, "tile_h": tile_h, "tile_w": tile_w, "chunk": chunk, "threads": threads,
            "batch": batch, "stage_bins": stage_bins, "smem_bytes": smem}


def _bwd_plan_args(plan: dict):
    return tuple(plan[k] for k in ("tile_h", "tile_w", "chunk", "threads", "batch",
                                   "stage_bins", "smem_bytes"))


def _acc_dtype(dtype):
    """Accumulation dtype of the twins: f32, or f64 for f64 features."""
    return torch.promote_types(dtype, torch.float32)


def _geometry(rois, h: int, w: int, p: int, sr: int, spatial_scale: float):
    scaled = rois.float() * spatial_scale
    ys = _axis_samples(scaled[..., 1], scaled[..., 3], p, sr, h)
    xs = _axis_samples(scaled[..., 0], scaled[..., 2], p, sr, w)
    return ys, xs


def roi_align_reference(feat, rois, output_size: int = 7,
                        spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """RoIAlign (torchvision aligned=False, fixed sampling ratio).
    feat (B, H, W, C), rois (B, R, 4) image coords → (B, R, p, p, C) in
    feat's dtype."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    p, sr = output_size, sampling_ratio
    acc_dt = _acc_dtype(feat.dtype)
    (yl, yh, wyl, wyh), (xl, xh, wxl, wxh) = _geometry(rois, h, w, p, sr, spatial_scale)
    flat = feat.reshape(b, h * w, c)
    out = torch.empty((b, r, p, p, c), dtype=feat.dtype, device=feat.device)
    for r0 in range(0, r, _CHUNK):
        sl = slice(r0, r0 + _CHUNK)
        acc = 0.0
        for yi, wy in ((yl[:, sl], wyl[:, sl]), (yh[:, sl], wyh[:, sl])):
            for xi, wx in ((xl[:, sl], wxl[:, sl]), (xh[:, sl], wxh[:, sl])):
                idx = (yi[..., :, None] * w + xi[..., None, :]).flatten(1)
                vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).to(acc_dt)
                wgt = (wy[..., :, None] * wx[..., None, :]).flatten(1)
                acc = acc + vals * wgt[..., None]
        rc = acc.shape[1] // (p * sr * p * sr)
        acc = acc.reshape(b, rc, p, sr, p, sr, c).mean(dim=(3, 5))
        out[:, sl] = acc.to(feat.dtype)
    return out


def roi_plan(c: int, element_size: int, output_size: int = 7, sampling_ratio: int = 2) -> dict:
    """Launch geometry of the forward kernels (K2, K6) for maps of ``c``
    channels of ``element_size`` bytes: ``vec`` channels a thread (16 bytes'
    worth where a pixel's channels are a multiple of 16 bytes, else 1),
    ``chunk`` channels a block, ``threads`` a block, ``smem_bytes`` of staging
    buffer: at least ``vec`` channels of the (2 * p * sr)^2 pixels a roi
    touches at most, so that any roi is served (a roi with many distinct
    pixels takes its chunk in passes)."""
    vec = 16 // element_size
    if c % vec:
        vec = 1
    chunk = max(vec, min(c, CHUNK_CHANNELS) // vec * vec)
    ns = output_size * sampling_ratio
    if ns > MAX_SAMPLES:
        raise ValueError(f"roi_align: {ns} samples an axis, the kernel takes {MAX_SAMPLES}")
    smem = max(STAGE_BYTES, -(-(2 * ns) ** 2 * vec * element_size // 16) * 16)
    return {"vec": vec, "chunk": chunk, "threads": FORWARD_THREADS, "smem_bytes": smem}


def staged_pixels(rois, h: int, w: int, output_size: int = 7,
                  spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """(B, R) int: the pixels the forward kernel stages for each roi, distinct
    rows x distinct columns touched by its non-empty samples (low and high
    corner of each).  Against the 16 corner reads of each of the p * p bins
    this is the staging's saving."""
    def distinct(low, high, w_lo, w_hi, size):
        live = ((w_lo != 0) | (w_hi != 0)).float()
        hits = torch.zeros((*low.shape[:2], size), device=low.device)
        hits.scatter_reduce_(2, low, live, "amax")
        hits.scatter_reduce_(2, high, live, "amax")
        return (hits > 0).sum(-1)

    ys, xs = _geometry(rois, h, w, output_size, sampling_ratio, spatial_scale)
    return distinct(*ys, h) * distinct(*xs, w)


def roi_align_forward(feat, rois, output_size: int = 7,
                      spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2,
                      plan: dict | None = None):
    """RoIAlign over a batch: feat (B, H, W, C) f32/bf16, rois (B, R, 4) →
    (B, R, p, p, C).  CPU tensors run the plain twin; CUDA tensors launch
    the kernel (one launch for the whole batch) with the geometry of
    ``roi_plan`` (or ``plan``)."""
    if not feat.is_cuda:
        return roi_align_reference(feat, rois, output_size, spatial_scale,
                                   sampling_ratio)
    b, h, w, c = feat.shape
    r = rois.shape[1]
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align: unsupported dtype {feat.dtype}")
    feat = feat.contiguous()
    rois = rois.float().contiguous()
    build.check_cuda("roi_align feat", feat, feat.dtype, (b, h, w, c))
    build.check_cuda("roi_align rois", rois, torch.float32, (b, r, 4))
    p = output_size
    if plan is None:
        plan = roi_plan(c, feat.element_size(), p, int(sampling_ratio))
    out = torch.empty((b, r, p, p, c), dtype=feat.dtype, device=feat.device)
    build.launch("frcnn_roi_align_fwd", feat.data_ptr(),
                 int(feat.dtype == torch.bfloat16), rois.data_ptr(), b, h, w, c,
                 r, p, int(sampling_ratio), float(spatial_scale), plan["chunk"],
                 plan["threads"], plan["smem_bytes"], out.data_ptr())
    build.LAUNCH_COUNTS["roi_align"] += 1
    return out


def roi_align_multilevel_reference(feats, rois, levels, strides, output_size: int = 7,
                                   sampling_ratio: int = 2):
    """Level-assigned RoIAlign over a pyramid: feats, L maps (B, H_l, W_l, C)
    of one dtype; rois (B, R, 4) image coordinates; levels (B, R) int in
    [0, L); strides, L ints → (B, R, p, p, C) in the feature dtype, each
    roi pooled from its level at scale 1 / stride (zeros for a level
    outside [0, L))."""
    out = None
    for li, (feat, stride) in enumerate(zip(feats, strides)):
        pooled = roi_align_reference(feat, rois, output_size, 1.0 / stride, sampling_ratio)
        on_level = (levels == li)[..., None, None, None]
        out = torch.where(on_level, pooled, 0.0 if out is None else out)
    return out


def roi_align_multilevel_forward(feats, rois, levels, strides, output_size: int = 7,
                                 sampling_ratio: int = 2):
    """The multilevel RoIAlign of ``roi_align_multilevel_reference``, over a
    batch.  CPU tensors run the plain twin; CUDA tensors launch K6 (one
    launch for every level and image, rois in their own order).  The
    result carries no gradient: ``RoIAlignMultilevelFunction`` joins it to
    K6b."""
    if not feats[0].is_cuda:
        return roi_align_multilevel_reference(feats, rois, levels, strides, output_size,
                                              sampling_ratio)
    b, _, _, c = feats[0].shape
    dtype = feats[0].dtype
    r = rois.shape[1]
    n = len(feats)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align_multilevel: unsupported dtype {dtype}")
    if len(strides) != n:
        raise ValueError(f"roi_align_multilevel: {n} maps but {len(strides)} strides")
    feats = [f.contiguous() for f in feats]
    for li, f in enumerate(feats):
        build.check_cuda(f"roi_align_multilevel level {li}", f, dtype,
                         (b, f.shape[1], f.shape[2], c))
    rois = rois.float().contiguous()
    levels = levels.to(torch.int32).contiguous()
    build.check_cuda("roi_align_multilevel rois", rois, torch.float32, (b, r, 4))
    build.check_cuda("roi_align_multilevel levels", levels, torch.int32, (b, r))
    p = output_size
    plan = roi_plan(c, feats[0].element_size(), p, int(sampling_ratio))
    out = torch.empty((b, r, p, p, c), dtype=dtype, device=rois.device)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats])
    dims = (ctypes.c_int * (2 * n))(*[s for f in feats for s in f.shape[1:3]])
    scales = (ctypes.c_float * n)(*[1.0 / s for s in strides])
    build.launch("frcnn_roi_align_ml_fwd", ptrs, dims, scales, n,
                 int(dtype == torch.bfloat16), rois.data_ptr(), levels.data_ptr(), b, c, r,
                 p, int(sampling_ratio), plan["chunk"], plan["threads"], plan["smem_bytes"],
                 out.data_ptr())
    build.LAUNCH_COUNTS["roi_align_ml"] += 1
    return out


def roi_align_backward_reference(dout, rois, feat_hw, output_size: int = 7,
                                 spatial_scale: float = 1.0 / 16.0,
                                 sampling_ratio: int = 2):
    """dF of RoIAlign: dout (B, R, p, p, C), rois (B, R, 4), feat_hw (H, W)
    → (B, H, W, C) in dout's dtype, accumulated in f32 (f64 for f64)."""
    b, r, p, _, c = dout.shape
    h, w = feat_hw
    sr = sampling_ratio
    acc_dt = _acc_dtype(dout.dtype)
    (yl, yh, wyl, wyh), (xl, xh, wxl, wxh) = _geometry(rois, h, w, p, sr, spatial_scale)
    dfeat = torch.zeros((b * h * w, c), dtype=acc_dt, device=dout.device)
    base = (torch.arange(b, device=dout.device) * (h * w))[:, None]
    inv_count = torch.tensor(1.0 / (sr * sr), dtype=acc_dt, device=dout.device)
    for r0 in range(0, r, _CHUNK):
        sl = slice(r0, r0 + _CHUNK)
        rc = dout[:, sl].shape[1]
        # each bin's gradient, repeated over its sr x sr samples: (B, rc*(p*sr)^2, C)
        g = dout[:, sl].to(acc_dt) * inv_count
        g = g[:, :, :, None, :, None, :].expand(b, rc, p, sr, p, sr, c)
        g = g.reshape(b, rc * p * sr * p * sr, c)
        for yi, wy in ((yl[:, sl], wyl[:, sl]), (yh[:, sl], wyh[:, sl])):
            for xi, wx in ((xl[:, sl], wxl[:, sl]), (xh[:, sl], wxh[:, sl])):
                idx = (yi[..., :, None] * w + xi[..., None, :]).flatten(1) + base
                wgt = (wy[..., :, None] * wx[..., None, :]).flatten(1).to(acc_dt)
                dfeat.index_add_(0, idx.flatten(), (g * wgt[..., None]).reshape(-1, c))
    return dfeat.reshape(b, h, w, c).to(dout.dtype)


def roi_align_backward(dout, rois, feat_hw, output_size: int = 7,
                       spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2,
                       plan: dict | None = None):
    """dF of RoIAlign over a batch: dout (B, R, p, p, C) f32/bf16, rois
    (B, R, 4) → (B, H, W, C) in dout's dtype.  CPU tensors run the plain
    twin; CUDA tensors launch K2b (one launch for the whole batch) with the
    geometry of ``roi_bwd_plan`` (or ``plan``)."""
    if not dout.is_cuda:
        return roi_align_backward_reference(dout, rois, feat_hw, output_size,
                                            spatial_scale, sampling_ratio)
    b, r, p, _, c = dout.shape
    h, w = feat_hw
    if dout.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align_backward: unsupported dtype {dout.dtype}")
    dout = dout.contiguous()
    rois = rois.float().contiguous()
    build.check_cuda("roi_align_backward dout", dout, dout.dtype, (b, r, p, p, c))
    build.check_cuda("roi_align_backward rois", rois, torch.float32, (b, r, 4))
    if plan is None:
        plan = roi_bwd_plan(c, dout.element_size(), p, int(sampling_ratio))
    dfeat = torch.empty((b, h, w, c), dtype=dout.dtype, device=dout.device)
    build.launch("frcnn_roi_align_bwd", dout.data_ptr(), int(dout.dtype == torch.bfloat16),
                 rois.data_ptr(), b, h, w, c, r, p, int(sampling_ratio), float(spatial_scale),
                 *_bwd_plan_args(plan), dfeat.data_ptr())
    build.LAUNCH_COUNTS["roi_align_bwd"] += 1
    return dfeat


class RoIAlignFunction(torch.autograd.Function):
    """RoIAlign with its gradient: forward K2 (``roi_align_forward``),
    backward K2b (``roi_align_backward``) — the kernels on CUDA tensors, their
    twins on CPU tensors.  rois get no gradient (they are detached in the
    lineage, and the TPU kernel's VJP returns zeros for them)."""

    @staticmethod
    def forward(ctx, feat, rois, output_size, spatial_scale, sampling_ratio):
        ctx.save_for_backward(rois)
        ctx.geometry = (feat.shape[1], feat.shape[2], output_size, spatial_scale,
                        sampling_ratio)
        return roi_align_forward(feat, rois, output_size, spatial_scale, sampling_ratio)

    @staticmethod
    def backward(ctx, dout):
        (rois,) = ctx.saved_tensors
        h, w, p, scale, sr = ctx.geometry
        dfeat = roi_align_backward(dout, rois, (h, w), p, scale, sr)
        return dfeat, None, None, None, None


def roi_align_multilevel_backward_reference(dout, rois, levels, level_hws, strides,
                                            output_size: int = 7, sampling_ratio: int = 2):
    """dF of the multilevel RoIAlign: dout (B, R, p, p, C), rois (B, R, 4),
    levels (B, R) int, level_hws: L pairs (H_l, W_l), strides: L ints → a
    list of L tensors (B, H_l, W_l, C) in dout's dtype, accumulated in f32
    (f64 for f64).  A roi adds to its own level only; a level outside
    [0, L) adds nothing."""
    grads = []
    for li, (hw, stride) in enumerate(zip(level_hws, strides)):
        on_level = (levels == li)[..., None, None, None]
        grads.append(roi_align_backward_reference(
            torch.where(on_level, dout, 0.0), rois, tuple(hw), output_size, 1.0 / stride,
            sampling_ratio))
    return grads


def roi_align_multilevel_backward(dout, rois, levels, level_hws, strides,
                                  output_size: int = 7, sampling_ratio: int = 2,
                                  plan: dict | None = None):
    """dF of the multilevel RoIAlign over a batch, as
    ``roi_align_multilevel_backward_reference``: a list of L dense tensors
    (B, H_l, W_l, C) in dout's dtype.  CPU tensors run the plain twin; CUDA
    tensors launch K6b (one launch for every level and image) with the
    geometry of ``roi_bwd_plan`` (or ``plan``).  On the card the L results
    are views of one buffer, the levels end to end."""
    if not dout.is_cuda:
        return roi_align_multilevel_backward_reference(dout, rois, levels, level_hws, strides,
                                                       output_size, sampling_ratio)
    b, r, p, _, c = dout.shape
    n = len(level_hws)
    if dout.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align_multilevel_backward: unsupported dtype {dout.dtype}")
    if len(strides) != n:
        raise ValueError(f"roi_align_multilevel_backward: {n} level sizes but "
                         f"{len(strides)} strides")
    if p != output_size:
        raise ValueError(f"roi_align_multilevel_backward: dout has {p} bins a side, "
                         f"output_size is {output_size}")
    dout = dout.contiguous()
    rois = rois.float().contiguous()
    levels = levels.to(torch.int32).contiguous()
    build.check_cuda("roi_align_multilevel_backward dout", dout, dout.dtype, (b, r, p, p, c))
    build.check_cuda("roi_align_multilevel_backward rois", rois, torch.float32, (b, r, 4))
    build.check_cuda("roi_align_multilevel_backward levels", levels, torch.int32, (b, r))
    if plan is None:
        plan = roi_bwd_plan(c, dout.element_size(), p, int(sampling_ratio))
    sizes = [b * h * w * c for h, w in level_hws]
    flat = torch.empty(sum(sizes), dtype=dout.dtype, device=dout.device)
    dims = (ctypes.c_int * (2 * n))(*[int(s) for hw in level_hws for s in hw])
    scales = (ctypes.c_float * n)(*[1.0 / s for s in strides])
    build.launch("frcnn_roi_align_ml_bwd", dout.data_ptr(), int(dout.dtype == torch.bfloat16),
                 rois.data_ptr(), levels.data_ptr(), dims, scales, n, b, c, r, p,
                 int(sampling_ratio), *_bwd_plan_args(plan), flat.data_ptr())
    build.LAUNCH_COUNTS["roi_align_ml_bwd"] += 1
    return [part.view(b, h, w, c) for part, (h, w) in zip(flat.split(sizes), level_hws)]


class RoIAlignMultilevelFunction(torch.autograd.Function):
    """Multilevel RoIAlign with its gradient: forward K6
    (``roi_align_multilevel_forward``), backward K6b
    (``roi_align_multilevel_backward``) — the kernels on CUDA tensors, their
    twins on CPU tensors.  The level maps come last, one argument each (a
    Function differentiates tensors, not lists); every map gets a dense
    gradient; rois and levels get none (the TPU kernel's VJP returns zeros
    for them)."""

    @staticmethod
    def forward(ctx, rois, levels, strides, output_size, sampling_ratio, *feats):
        ctx.save_for_backward(rois, levels)
        ctx.geometry = ([tuple(f.shape[1:3]) for f in feats], tuple(strides), output_size,
                        sampling_ratio)
        return roi_align_multilevel_forward(list(feats), rois, levels, strides, output_size,
                                            sampling_ratio)

    @staticmethod
    def backward(ctx, dout):
        rois, levels = ctx.saved_tensors
        level_hws, strides, p, sr = ctx.geometry
        grads = roi_align_multilevel_backward(dout, rois, levels, level_hws, strides, p, sr)
        return (None, None, None, None, None, *grads)
