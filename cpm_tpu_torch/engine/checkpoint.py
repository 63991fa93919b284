"""Checkpointing: `torch.save` of the train state with the reference's layout.

The port of cpm_tpu/engine/checkpoint.py (after the reference's
pet/utils/checkpointer.py:35-158), where orbax becomes `torch.save`:
  * a checkpoint holds the step, the model's f32 master `state_dict`, the
    optimizer's `state_dict` (SGD's momentum buffers, ADAM's moments and
    count, RMSPROP's nu and trace) and the samplers' `Draws` generator state;
  * `model_latest` is written at every save, and an iteration-tagged copy
    `model_iter<N>` when a snapshot is asked for (save:124-137);
  * each file is written under a temporary name and then renamed over the
    old one, so that a run stopped mid-save leaves the previous checkpoint;
  * auto-resume reads `model_latest` when TRAIN.AUTO_RESUME (:47-54);
  * under a data-parallel group rank 0 alone writes (every rank holds the
    same state), and the others wait for the write at a barrier; every rank
    reads what rank 0 wrote.
"""

import os

import torch

from cpm_tpu_torch.parallel.mesh import barrier, is_main_process, rank0_value


class CheckPointer:
    def __init__(self, ckpt_dir: str, auto_resume: bool = True):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.latest_path = os.path.join(self.ckpt_dir, "model_latest")
        # With several processes the resume decision must be collective:
        # ranks that decided from their own os.path.exists and disagreed (an
        # eventually consistent file system, a racing save) would take
        # different branches and the job would hang at its next collective.
        self._exists = self._collective_exists()
        self.resumed = auto_resume and self._exists

    def _collective_exists(self) -> bool:
        """Whether `model_latest` exists, as every rank must agree: rank 0's
        answer, broadcast to every rank."""
        return rank0_value(os.path.exists(self.latest_path))

    def save(self, state, step: int, snapshot: bool = False):
        """Write model_latest (+ the model_iter<N> snapshot copy); under a
        group every rank calls it, rank 0 writes and the others wait."""
        payload = {
            "step": int(step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "draws": state.draws.state_dict(),
        }
        paths = [self.latest_path]
        if snapshot:
            paths.append(os.path.join(self.ckpt_dir, f"model_iter{step}"))
        if is_main_process():
            for path in paths:
                tmp = f"{path}.tmp"
                torch.save(payload, tmp)
                os.replace(tmp, path)
        barrier()
        self._exists = True

    def load(self, state):
        """Restore model_latest into `state` (a `TrainState`) in place and
        return it, or return None when there is nothing to load. The model,
        and the optimizer and the draws where the state has them, take the
        saved tensors on their own device; `state.step` the saved step."""
        # re-evaluated when __init__ saw nothing: a checkpoint may have been
        # written since (e.g. by this process)
        if not self._exists:
            self._exists = self._collective_exists()
        if not self._exists:
            return None
        device = next(state.model.parameters()).device
        payload = torch.load(self.latest_path, map_location=device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        if state.optimizer is not None:
            state.optimizer.load_state_dict(payload["optimizer"])
        if state.draws is not None:
            # the generator lives on the CPU, whatever the model's device
            state.draws.load_state_dict(
                {k: v.cpu() for k, v in payload["draws"].items()})
        state.step = int(payload["step"])
        return state

