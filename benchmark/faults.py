"""Faults planted under the timed path, to show that `correct` catches them:
the tests run a whole harness run with each, and calibrate.py reads them on
the chip."""

import torch


def unchanged_state(step_fn):
    """A step that computes its losses and returns its state unchanged: the
    parameters are put back after the update."""
    def step(state, batch):
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        saved = [p.detach().clone() for p in params]
        state, metrics = step_fn(state, batch)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        return state, metrics
    return step


def half_batch(step_fn):
    """A step on the first half of the batch's rows alone, its losses the
    mean over those."""
    def step(state, batch):
        n = len(batch["images"]) // 2
        return step_fn(state, {k: v[:n] for k, v in batch.items()})
    return step


def altered_answer(forward):
    """A forward whose detections carry the next class's label."""
    def fwd(images, image_sizes):
        dets = forward(images, image_sizes)
        return dets._replace(labels=dets.labels % 80 + 1)
    return fwd


def shifted_boxes(forward):
    """A forward whose boxes move right and down by a tenth of their width
    and height."""
    def fwd(images, image_sizes):
        dets = forward(images, image_sizes)
        b = dets.boxes
        step = torch.stack([b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]], -1).repeat(1, 1, 2)
        return dets._replace(boxes=b + 0.1 * step)
    return fwd


def cut_count(forward):
    """A forward that serves the first half of its detections."""
    def fwd(images, image_sizes):
        dets = forward(images, image_sizes)
        keep = torch.cumsum(dets.mask.long(), dim=-1) <= dets.mask.sum(dim=-1, keepdim=True) // 2
        return dets._replace(mask=dets.mask & keep)
    return fwd


class _ScaledCoordinateGradient(torch.autograd.Function):
    """The identity on the coordinates, their gradients scaled by 1.5."""

    @staticmethod
    def forward(ctx, ys, xs):
        return ys.view_as(ys), xs.view_as(xs)

    @staticmethod
    def backward(ctx, gys, gxs):
        return gys * 1.5, gxs * 1.5


def coordinate_gradient(sample):
    """A deformable sampler whose coordinates' gradients (kernel 6b's) come
    out half as large again."""
    def faulty(feat, ys, xs):
        return sample(feat, *_ScaledCoordinateGradient.apply(ys, xs))
    return faulty
