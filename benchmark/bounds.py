"""The yardstick's arithmetic: the H100's published peaks, the least time a
pooler or sampler call could take on the card, and the capture of what the
port's pooler and sampler were given in the traced window.

Peaks are NVIDIA's H100 SXM data sheet (dense): 989 TFLOP/s bf16, 67 TFLOP/s
f32 outside the tensor cores, 3.35 TB/s of HBM. A call's bound is the larger
of its bytes over the bandwidth and its f32 multiply-adds over 67 TFLOP/s,
as the port's tools/bench_roi_align.py and tools/probe_dcn_sampler.py count
them (see benchmark/README.md): RoIAlign forward, the level cells the valid
rois touch read once, the rois read and the output written; its backward,
the valid rois' rows of the output gradient read and every level map's
gradient written once; the sampler, every weighed cell once, 8 bytes of
coordinates and the output (backward: the gradient, the cells, and both
gradients written).
"""

import contextlib

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

ROI_FORWARD_KERNELS = ("roi_align_fwd_kernel",)
ROI_BACKWARD_KERNELS = ("roi_tile_backward_kernel",)
SAMPLER_KERNELS = ("deform_sample_", "bin_count_kernel", "bin_scan_", "bin_place_kernel")


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def touched_cells(shapes, rois, levels, valid, pool, scales) -> int:
    """Level cells the valid rois read: those an all-ones output gradient
    reaches through the plain RoIAlign at one channel."""
    from benchmark.reference.ops.roi_align import multilevel_roi_align

    maps = [torch.zeros((s[0], s[1], s[2], 1), device=rois.device, requires_grad=True)
            for s in shapes]
    out = multilevel_roi_align(maps, rois, levels.long(), pool, scales, 0)
    (out * valid.to(out.dtype)[:, None, None, None]).sum().backward()
    return sum(int((m.grad != 0).sum()) for m in maps)


def roi_align_bounds(shapes, rois, levels, valid, pool, elem_size, scales):
    """(forward s, backward s, forward bytes, backward bytes, flops) of one
    multilevel RoIAlign call; `shapes` are the levels' [B, H, W, C]."""
    channels = shapes[0][3]
    cells = touched_cells(shapes, rois, levels, valid, pool, scales)
    n, n_valid = rois.shape[0], int(valid.sum())
    bins = pool[0] * pool[1]
    roi_bytes = n * (5 * 4 + 4 + 1)
    fwd_bytes = cells * channels * elem_size + roi_bytes + n * bins * channels * elem_size
    map_bytes = sum(s[0] * s[1] * s[2] for s in shapes) * channels * elem_size
    bwd_bytes = n_valid * bins * channels * elem_size + roi_bytes + map_bytes
    flops = n_valid * bins * 4 * 4 * channels * 2  # samples x cells x (mul, add)
    return bound_s(fwd_bytes, flops), bound_s(bwd_bytes, flops), fwd_bytes, bwd_bytes, flops


def sampler_bounds(shape, elem_size, ys, xs):
    """(forward s, backward s, forward bytes, backward bytes, forward flops)
    of one sampler call on a [B, H, W, C] map at coordinates ys, xs."""
    from benchmark.reference.ops.deform_conv import _tent_axis

    b, h, w, c = shape
    ys, xs = ys.flatten(1), xs.flatten(1)
    yi, wy = _tent_axis(ys, h)
    xi, wx = _tent_axis(xs, w)
    image = torch.arange(b, device=ys.device)[:, None] * (h * w)
    touched, weighed = [], 0
    for i in (0, 1):
        for j in (0, 1):
            live = (wy[..., i] * wx[..., j]) > 0
            weighed += int(live.sum())
            touched.append((image + yi[..., i] * w + xi[..., j])[live])
    cells = int(torch.unique(torch.cat(touched)).numel())
    n = ys.numel()
    fwd_bytes = cells * c * elem_size + n * 8 + n * c * elem_size
    bwd_bytes = n * c * elem_size + cells * c * elem_size + n * 8 + b * h * w * c * elem_size + n * 8
    return (bound_s(fwd_bytes, weighed * c * 2), bound_s(bwd_bytes, weighed * c * 4),
            fwd_bytes, bwd_bytes, weighed * c * 2)


class Captures:
    """While `armed`, what each call of the port's pooler and deformable
    sampler was given: the pooler's rois and mask with its maps' shapes
    (replay.PoolerCalls), the sampler's coordinates; never the maps."""

    def __init__(self):
        from benchmark.replay import PoolerCalls

        self.pooler = PoolerCalls()
        self.sampler_calls = []
        self._armed = False

    @property
    def armed(self):
        return self._armed

    @armed.setter
    def armed(self, on):
        self._armed = self.pooler.armed = bool(on)

    @contextlib.contextmanager
    def installed(self):
        from cpm_tpu_torch.ops import deform_conv, pooler

        real_sample = deform_conv.deform_sample

        def sample(feat, ys, xs):
            if self._armed:
                self.sampler_calls.append(dict(shape=tuple(feat.shape), elem=feat.element_size(),
                                               ys=ys.detach().clone(), xs=xs.detach().clone()))
            return real_sample(feat, ys, xs)

        deform_conv.deform_sample = sample
        try:
            with self.pooler.installed(pooler):
                yield self
        finally:
            deform_conv.deform_sample = real_sample

    def totals(self) -> dict:
        """Summed bounds (s), bytes and flops of the captured multilevel
        pooler calls (the one-level ones go to another kernel) and sampler
        calls."""
        from benchmark.reference.ops.pooler import assign_fpn_levels

        roi_calls = [c for c in self.pooler.calls if len(c["shapes"]) > 1]
        t = dict(roi_fwd_s=0.0, roi_bwd_s=0.0, roi_fwd_bytes=0, roi_bwd_bytes=0, roi_flops=0,
                 roi_calls=len(roi_calls), sampler_fwd_s=0.0, sampler_bwd_s=0.0,
                 sampler_fwd_bytes=0, sampler_bwd_bytes=0, sampler_flops=0,
                 sampler_calls=len(self.sampler_calls))
        with torch.enable_grad():
            for c in roi_calls:
                k_min, k_max, scale, level = c["rule"]
                levels = assign_fpn_levels(c["rois"][:, 1:5], k_min, k_max, scale, level) - k_min
                f, b, fb, bb, fl = roi_align_bounds(c["shapes"], c["rois"], levels, c["mask"],
                                                    c["pool"], c["elem"], c["scales"])
                t["roi_fwd_s"] += f
                t["roi_fwd_bytes"] += fb
                t["roi_flops"] += fl
                if c["backward"]:
                    t["roi_bwd_s"] += b
                    t["roi_bwd_bytes"] += bb
        for c in self.sampler_calls:
            f, b, fb, bb, fl = sampler_bounds(c["shape"], c["elem"], c["ys"], c["xs"])
            t["sampler_fwd_s"] += f
            t["sampler_bwd_s"] += b
            t["sampler_fwd_bytes"] += fb
            t["sampler_bwd_bytes"] += bb
            t["sampler_flops"] += fl
        return t
