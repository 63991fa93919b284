"""Fixed-shape balanced positive/negative sampling.

Port of cpm_tpu/utils/sampler.py (`sample_k_from_mask`, `balanced_sample`):
selection by rank over uniform priorities. The JAX package draws the
priorities from a PRNG key inside these functions; threefry cannot be
reproduced here, so each function takes its uniform draws as an argument
(`noise`, of the mask's shape); left out, they are drawn from an explicit
`torch.Generator`. `Draws` hands them out to the train forward: from a
`torch.Generator` on the CPU, so that the CPU and the card see the same
numbers, or from a list of arrays consumed in call order, as the tests do.
Under data parallelism each draw is made at the global batch and the rank
takes its rows, as the JAX program draws global arrays: N ranks see the
numbers that one process over their images would.
"""

from typing import Optional, Sequence, Union

import numpy as np
import torch


class Draws:
    """A source of uniform [0, 1) tensors of a given shape on a device.

    Every shape asked for has the batch as its leading dimension. Rank
    `rank` of `world_size` gets its rows of a draw at `world_size` times
    that dimension (a list's arrays hold the global draws), so that every
    rank's source advances alike."""

    def __init__(self, source: Union[torch.Generator, Sequence[np.ndarray]],
                 rank: int = 0, world_size: int = 1):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of {world_size}")
        self._generator = source if isinstance(source, torch.Generator) else None
        self._arrays = None if self._generator is not None else list(source)
        self.rank, self.world_size = rank, world_size
        self.shapes = []  # shapes handed out (this rank's), in order

    def __call__(self, shape, device) -> torch.Tensor:
        shape = tuple(int(d) for d in shape)
        self.shapes.append(shape)
        full = (shape[0] * self.world_size,) + shape[1:]
        if self._generator is not None:
            u = torch.rand(full, generator=self._generator)
        else:
            if len(self.shapes) > len(self._arrays):
                raise IndexError(f"draw {len(self.shapes)} requested of {len(self._arrays)}")
            a = np.asarray(self._arrays[len(self.shapes) - 1], np.float32)
            if a.shape != full:
                raise ValueError(f"draw {len(self.shapes)}: array {a.shape}, wanted {full}")
            u = torch.from_numpy(a)
        if self.world_size > 1:
            u = u[self.rank * shape[0]:(self.rank + 1) * shape[0]]
        return u.to(device)

    def state_dict(self) -> dict:
        """The generator's state, which a checkpoint keeps so that a resumed
        run draws what an uninterrupted one would. A list of arrays is a
        test's fixed stream and has no state to keep."""
        if self._generator is None:
            raise TypeError("Draws over a list of arrays has no state to save")
        return {"generator": self._generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        if self._generator is None:
            raise TypeError("Draws over a list of arrays has no state to load")
        self._generator.set_state(state["generator"])


def _uniform(mask, noise, generator) -> torch.Tensor:
    if noise is not None:
        if noise.shape != mask.shape:
            raise ValueError(f"noise {tuple(noise.shape)} for a mask {tuple(mask.shape)}")
        return noise
    if generator is None:
        raise ValueError("pass the uniform draws (noise) or a torch.Generator")
    return torch.rand(mask.shape, generator=generator, device=generator.device).to(mask.device)


def sample_k_from_mask(
    mask: torch.Tensor, k, noise: Optional[torch.Tensor] = None, *,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Select exactly min(k, sum(mask)) elements of mask along the last dim:
    those of lowest `noise`, equal values in index order. k is an int or an
    integer tensor over the leading dims. Returns a bool mask."""
    noise = _uniform(mask, noise, generator)
    inf = torch.full_like(noise, float("inf"))
    priority = torch.where(mask, noise, inf)
    order = torch.argsort(priority, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(mask.shape[-1], device=mask.device).expand_as(order))
    if isinstance(k, torch.Tensor):
        k = k[..., None]
    return mask & (rank < k)


def balanced_sample(
    pos_mask: torch.Tensor,
    neg_mask: torch.Tensor,
    batch_size_per_image: int,
    positive_fraction: float,
    noise_pos: Optional[torch.Tensor] = None,
    noise_neg: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
):
    """Up to batch * positive_fraction positives, the rest negatives, as
    binary masks over [..., N] candidates. The positives' draws come first."""
    noise_pos = _uniform(pos_mask, noise_pos, generator)
    noise_neg = _uniform(neg_mask, noise_neg, generator)
    max_pos = int(batch_size_per_image * positive_fraction)
    num_pos = torch.clamp(pos_mask.sum(dim=-1), max=max_pos)
    num_neg = torch.minimum(neg_mask.sum(dim=-1), batch_size_per_image - num_pos)
    return (
        sample_k_from_mask(pos_mask, num_pos, noise_pos),
        sample_k_from_mask(neg_mask, num_neg, noise_neg),
    )
