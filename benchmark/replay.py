"""The replay: the plain reference following the port from its own state.

With random weights every discrete choice of the heads sits on near-ties:
the RPN's top-k and NMS, the classifier's per-class NMS, and each grid
point's argmax over its heatmap, which bfloat16's rounding moves anywhere in
the roi. Two sound runs then serve different boxes. So the reference follows
the port from its own state, as a served language model is judged on its
own tokens: it pools the port's rois at each of the port's pooler calls
(serving), or takes each checked step's proposals and rois (training), and
works out again what the port computed there. The stages that the replay
skips are checked by themselves, the port's function against the
reference's on the same float32 inputs:

  proposal_stage  widest coordinate difference (px) between the port's
                  `select_proposals` and the reference's, on the
                  reference's RPN outputs
  sampler_stage   widest gap between the port's deformable sampler
                  (`deform_sample`, kernels 6f / 6b) and the reference's,
                  forward and backward (the map's and the coordinates'
                  gradients), each over the reference's largest magnitude:
                  at the inputs of every sampler call of the first checked
                  step, in float32, under a seeded upstream gradient

The head's own part (its pooler calls, its decode, the served numbers) is a
module of `benchmark/replays/`, named by the configuration's `replay` key
(registry.Cell.head_replay). This module holds what every head shares.
"""

import contextlib
from typing import List

import torch


class PoolerCalls:
    """While `armed`, each call of `owner.Pooler` (the port's or the
    reference's pooler module) appends what it was given: the rois, their
    mask, the levels' shapes and element size, whether a gradient flows, and
    the pooler's level rule."""

    def __init__(self):
        self.armed = False
        self.calls: List[dict] = []

    @contextlib.contextmanager
    def installed(self, owner):
        real = owner.Pooler.__call__

        def call(pooler, features, rois, roi_mask=None):
            if self.armed:
                mask = (torch.ones(rois.shape[0], dtype=torch.bool, device=rois.device)
                        if roi_mask is None else roi_mask.detach().bool().clone())
                self.calls.append(dict(
                    rois=rois.detach().float().clone(), mask=mask,
                    shapes=[tuple(f.shape) for f in features],
                    elem=features[0].element_size(),
                    backward=torch.is_grad_enabled() and any(f.requires_grad for f in features),
                    pool=tuple(pooler.output_size), scales=tuple(pooler.scales),
                    rule=(pooler.k_min, pooler.k_max, pooler.canonical_scale,
                          pooler.canonical_level)))
            return real(pooler, features, rois, roi_mask)

        owner.Pooler.__call__ = call
        try:
            yield self
        finally:
            owner.Pooler.__call__ = real


def features(model, images, sizes):
    """The reference's FPN levels (NHWC, channels_last) and RPN outputs."""
    x = model._normalize_uint8(images) if images.dtype == torch.uint8 else images.float()
    feats = model.fpn(model.backbone(x.permute(0, 3, 1, 2)))
    feats = [f.contiguous(memory_format=torch.channels_last) for f in feats]
    return feats, [f.permute(0, 2, 3, 1) for f in feats]


class StageFns:
    """The functions whose outputs the stage checks hold to the
    reference's: the port's, or for the control (`control`) the
    reference's own on inputs in the control's precision. A head replay
    adds its own (`replays/<head>.py`)."""

    def __init__(self, control=False):
        self.control = control
        if control:
            from benchmark.reference.modeling.rpn import select_proposals
            from benchmark.reference.ops.deform_conv import deform_sample
            from benchmark.reference.precision import to_fp8

            self.select = lambda layout, obj, reg, *a, **k: select_proposals(
                layout, [to_fp8(o.bfloat16()) for o in obj], [to_fp8(r.bfloat16()) for r in reg],
                *a, **k)
            self.sample = lambda feat, ys, xs: deform_sample(
                to_fp8(feat.bfloat16()).float(), ys, xs)
            self.gradient = lambda g: to_fp8(g.bfloat16()).float()
        else:
            from cpm_tpu_torch.modeling.rpn import select_proposals
            from cpm_tpu_torch.ops.deform_conv import deform_sample

            self.select, self.sample, self.gradient = select_proposals, deform_sample, None


def widest(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).detach().abs().max()) if a.shape == b.shape and a.numel() else float("inf")


def proposal_check(model, feats, sizes, served_props, served_mask, fns):
    """(proposal_stage, proposal_gap): the stage check of the port's
    `select_proposals` on the reference's RPN outputs of the image; and the
    median distance of the reference's own proposals to the nearest of the
    port's, over the box's longer side (read, not compared)."""
    from benchmark.reference.modeling.rpn import select_proposals

    c = model.cfg
    objectness, box_reg = model.rpn_head(feats)
    layout = model._anchor_layout(feats)
    kw = dict(pre_nms_top_n=c.RPN.PRE_NMS_TOP_N_TEST, post_nms_top_n=c.RPN.POST_NMS_TOP_N_TEST,
              nms_thresh=c.RPN.NMS_THRESH, min_size=c.RPN.MIN_SIZE,
              fpn_post_nms_top_n=c.RPN.FPN_POST_NMS_TOP_N_TEST, box_coder=model.rpn_box_coder)
    props, _, mask = select_proposals(layout, objectness, box_reg, sizes, **kw)
    theirs, _, their_mask = fns.select(layout, objectness, box_reg, sizes, **kw)
    stage = widest(torch.where(mask[..., None], props, 0.0),
                   torch.where(their_mask[..., None], theirs, 0.0))
    want = props[0][mask[0]]
    got = served_props[served_mask]
    if not len(want) or not len(got):
        return stage, float("inf")
    side = torch.maximum(want[:, 2] - want[:, 0], want[:, 3] - want[:, 1]).clamp_min(1.0)
    dist = torch.cdist(want, got, p=float("inf")).min(dim=1).values / side
    return stage, float(dist.median())


def sampler_stage(calls, fns: StageFns, seed: int, device) -> float:
    """The widest of the forward's, the map gradient's and the coordinate
    gradients' gaps, each max |fns.sample's - the reference's| over the
    reference's max magnitude, at each captured call's map, in float32, and
    coordinates, under an upstream gradient drawn from `seed`."""
    from benchmark.reference.ops.deform_conv import deform_sample

    gen = torch.Generator(device=device).manual_seed(seed)
    worst = 0.0
    for c in calls:
        feat = c["feat"].to(device).float()
        ys, xs = c["ys"].to(device).float(), c["xs"].to(device).float()
        g = torch.randn((*ys.shape, feat.shape[-1]), generator=gen, device=device)
        outs = []
        for fn, grad in ((fns.sample, fns.gradient), (deform_sample, None)):
            leaves = [t.clone().requires_grad_() for t in (feat, ys, xs)]
            out = fn(*leaves)
            grads = torch.autograd.grad(out, leaves, grad(g) if grad else g)
            outs.append([out.detach(), *grads])
            del out, leaves
        for a, b in zip(*outs):
            scale = float(b.abs().max())
            gap = float((a.float() - b).abs().max())
            worst = max(worst, gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf")))
        del outs
    return worst


class ReplayMismatch(RuntimeError):
    """The recorded state does not fit the reference's step (a fault such as
    a batch cut short)."""


class TrainCapture:
    """While `armed`, what a training step's RoI head was given: the
    proposals at the head's entry and each pooler call's rois and mask, one
    record a step; and the inputs of each deformable sampler call of the
    first step, on the host. `model` is the port's (or, for the control,
    the reference's), `owner` its pooler module, `sampler_owner` its
    deform_conv module."""

    def __init__(self, model, owner, sampler_owner):
        self.model, self.owner, self.sampler_owner = model, owner, sampler_owner
        self.pooler = PoolerCalls()
        self.records: List[dict] = []
        self.sampler_calls: List[dict] = []
        self.armed = False

    @contextlib.contextmanager
    def installed(self):
        def hook(module, args):
            if self.armed:
                self.records.append(dict(proposals=args[1].detach().clone(),
                                         prop_mask=args[2].detach().clone(), calls=[]))
                self.pooler.calls = self.records[-1]["calls"]
            return None

        real_sample = self.sampler_owner.deform_sample

        def sample(feat, ys, xs):
            if self.armed and not self.records:
                self.sampler_calls.append({k: t.detach().to("cpu") for k, t in
                                           (("feat", feat), ("ys", ys), ("xs", xs))})
            return real_sample(feat, ys, xs)

        handle = self.model.roi_head.register_forward_pre_hook(hook)
        self.sampler_owner.deform_sample = sample
        try:
            with self.pooler.installed(self.owner):
                self.pooler.armed = True
                yield self
        finally:
            self.pooler.armed = False
            self.sampler_owner.deform_sample = real_sample
            handle.remove()


class TrainReplay:
    """The reference's replay of recorded training steps: each step's
    proposals (the point in reference/modeling/model.py that reads it), and
    the stage check of `select_proposals` on the reference's RPN outputs. A
    head replay subclasses it with the points of its head."""

    def __init__(self, capture: TrainCapture, fns: StageFns, seed: int):
        self.records, self.sampler_calls = capture.records, capture.sampler_calls
        self.fns, self.seed, self.step = fns, seed, -1
        self.proposal_stage = 0.0

    def proposals(self, proposals, prop_mask, rpn):
        self.step += 1
        if self.step >= len(self.records):
            raise ReplayMismatch(f"no record of step {self.step + 1}")
        rec = self.records[self.step]
        if rec["proposals"].shape != proposals.shape:
            raise ReplayMismatch(f"step {self.step + 1}: proposals {tuple(rec['proposals'].shape)}"
                                 f" recorded, {tuple(proposals.shape)} in the reference")
        layout, objectness, box_reg, sizes, gt, kw = rpn
        theirs, _, their_mask = self.fns.select(
            layout, objectness, box_reg, sizes, is_train=True, gt_boxes=gt["boxes"],
            gt_mask=gt["mask"], **kw)
        self.proposal_stage = max(self.proposal_stage, widest(
            torch.where(prop_mask[..., None], proposals, 0.0),
            torch.where(their_mask[..., None], theirs, 0.0)))
        return rec["proposals"].to(proposals.dtype), rec["prop_mask"]

    def call(self, index, shape):
        """Pooler call `index` of this step: its rois [*shape, 4] and mask."""
        calls = self.records[self.step]["calls"]
        if index >= len(calls):
            raise ReplayMismatch(f"step {self.step + 1}: {len(calls)} pooler calls recorded")
        rois, mask = calls[index]["rois"], calls[index]["mask"]
        if rois.shape[0] != shape[0] * shape[1]:
            raise ReplayMismatch(f"step {self.step + 1}, pooler call {index}: {rois.shape[0]} "
                                 f"rois recorded, {shape[0] * shape[1]} in the reference")
        return rois[:, 1:].reshape(*shape, 4), mask.reshape(shape)

    def numbers(self, device) -> dict:
        """The stage checks' readings, once the steps are replayed; the
        sampler's only where the model has one."""
        out = dict(proposal_stage=self.proposal_stage)
        if self.sampler_calls:
            out["sampler_stage"] = sampler_stage(self.sampler_calls, self.fns, self.seed, device)
        return out
