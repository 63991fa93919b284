"""Train CLI of the port.

    python -m cpm_tpu_torch.tools.train_net --cfg file.yaml [--device cuda|cpu] [KEY VALUE ...]

The contract of the JAX package's tools/train_net.py and of the reference's
tools/rcnn/train_net.py: a YAML config and trailing `KEY VALUE` overrides
(after the options). It copies the YAML into CKPT, builds the dataset and
the loader (TRAIN.BATCH_SIZE images a step on one device), builds the train
state from cfg.SEED, loads the pretrained trunk that an existing
TRAIN.WEIGHTS file holds (a reference torch checkpoint, imported by
utils/weight_import.py), resumes from CKPT's `model_latest` when there is one
(the loader skips to the restored step), and trains to SOLVER.MAX_ITER:
a log line every DISPLAY_ITER steps, a snapshot every SNAPSHOT_ITERS steps
and at the last one, `model_latest` at the end. The last line gives the
median step wall time, the median time a step waited for its batch and,
on a card, the peak device memory.

`--device` is `cuda` unless the caller asks for the CPU (`--device cpu`, as
the tests do, where every kernel runs its plain PyTorch version); without a
card, `cuda` raises. `main(argv)` runs in the caller's process and returns
the steps' records.

Data parallelism, the JAX package's mesh over every chip: started by
torchrun (its RANK, WORLD_SIZE and LOCAL_RANK; `--init-method`, env:// by
default, says where the ranks meet), each process joins the group
(parallel/mesh.py: NCCL on `cuda:LOCAL_RANK`, which must exist; gloo under
`--device cpu`), loads max(TRAIN.BATCH_SIZE // WORLD_SIZE, 1) images a step,
its rank's slice of each epoch, and steps on them as one process would on
the global batch. Rank 0 alone prints, logs and writes checkpoints; at the
end every rank's parameters must be rank 0's to the bit, or it raises:

    torchrun --standalone --nproc_per_node 8 -m cpm_tpu_torch.tools.train_net --cfg file.yaml
"""

import argparse
import os
import shutil
import statistics
import sys
import time

import torch


def arg_parser(description="CPM R-CNN training (PyTorch)") -> argparse.ArgumentParser:
    """The options both CLIs take; `parse_args` adds the trailing overrides."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu, where the kernels' plain versions run")
    return p


def train_arg_parser() -> argparse.ArgumentParser:
    p = arg_parser()
    p.add_argument("--init-method", default="env://",
                   help="where torchrun's ranks meet (a torch.distributed init_method)")
    return p


def parse_args(argv=None, parser=None):
    p = parser if parser is not None else arg_parser()
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                   help="config overrides, KEY VALUE pairs, after the options")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The device the CLI runs on; `cuda` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is False; "
                           "pass --device cpu to run on the CPU")
    return device


def load_config(cfg_file: str, opts):
    """A fresh config: the defaults, then the YAML, then the overrides."""
    from cpm_tpu_torch.config import (
        assert_and_infer_cfg,
        get_default_cfg,
        merge_cfg_from_file,
        merge_cfg_from_list,
    )

    cfg = get_default_cfg()
    merge_cfg_from_file(cfg_file, cfg)
    if opts:
        merge_cfg_from_list(opts, cfg)
    return assert_and_infer_cfg(cfg, make_immutable=False)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None):
    """Train as the config says; returns one record a step taken: `iter`
    (the step's number, from 1), every loss, `total_loss` and `lr`, and
    `step_s` and `wait_s` (the step's wall time, and the time it waited for
    its batch)."""
    return train(parse_args(argv, train_arg_parser()))[0]


def train(args):
    """`main` on parsed arguments: (the steps' records, the final train
    state). Under torchrun it joins the group first and leaves it at the
    end, whatever happens between."""
    from cpm_tpu_torch.parallel.mesh import destroy_data_group, in_torchrun, init_data_group

    if not in_torchrun():
        return _train(args, resolve_device(args.device), 0, 1)
    group = init_data_group(args.device, init_method=args.init_method)
    try:
        return _train(args, group.device, group.rank, group.world_size)
    finally:
        destroy_data_group()


def _train(args, device, rank, world):
    from cpm_tpu_torch.data.coco import ConcatDataset, build_dataset
    from cpm_tpu_torch.data.loader import TrainLoader, describe_decode_path
    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.parallel.mesh import ranks_agree
    from cpm_tpu_torch.utils.logger import TrainingLogger
    from cpm_tpu_torch.utils.weight_import import (
        import_resnet_backbone,
        merge_backbone_into_model,
        trunk_layers,
    )

    def say(text):
        if rank == 0:
            print(text, flush=True)

    cfg = load_config(args.cfg_file, args.opts)
    ckpt_dir = cfg.CKPT
    os.makedirs(ckpt_dir, exist_ok=True)
    if rank == 0:
        shutil.copyfile(args.cfg_file, os.path.join(ckpt_dir, os.path.basename(args.cfg_file)))

    datasets = build_dataset(cfg, cfg.TRAIN.DATASETS, is_train=True)
    dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    # each rank loads its slice of every epoch, as the JAX package's
    # processes do (tools/train_net.py:77 there)
    local_batch = max(cfg.TRAIN.BATCH_SIZE // world, 1)
    loader = TrainLoader(cfg, dataset, local_batch, rank=rank, world_size=world, seed=cfg.SEED)
    say(f"decode path: {describe_decode_path([loader])}")
    model, optimizer, state = create_train_state(cfg, device, cfg.SEED)
    if cfg.TRAIN.WEIGHTS and os.path.exists(cfg.TRAIN.WEIGHTS):
        # the pretrained trunk; a checkpoint to resume from wins over it
        merge_backbone_into_model(model, import_resnet_backbone(
            cfg.TRAIN.WEIGHTS, layers=trunk_layers(cfg), conv1_rgb2bgr=cfg.MODEL.CONV1_RGB2BGR))
        say(f"loaded pretrained backbone from {cfg.TRAIN.WEIGHTS}")

    checkpointer = CheckPointer(ckpt_dir, auto_resume=cfg.TRAIN.AUTO_RESUME)
    last_saved = None
    if checkpointer.resumed and checkpointer.load(state) is not None:
        # the resumed run consumes the batch stream an uninterrupted run
        # would (the reference restarts its IterationBasedBatchSampler at
        # scheduler.iteration, tools/rcnn/train_net.py:127)
        loader.start_iter = last_saved = state.step
        say(f"auto-resumed from iter {state.step}")
    step_fn = make_train_step(cfg, model, optimizer)
    max_iter = cfg.SOLVER.MAX_ITER
    logger = TrainingLogger(cfg.MODEL.TYPE, log_period=cfg.DISPLAY_ITER, max_iter=max_iter,
                            rank=rank)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    history = []
    batches = iter(loader)
    try:
        while state.step < max_iter:
            t0 = time.perf_counter()
            batch = next(batches)
            logger.data_time.update(time.perf_counter() - t0)
            logger.iter_tic()
            state, metrics = step_fn(state, batch)
            # reading the losses waits for the step to end on the device
            values = {k: float(v) for k, v in metrics.items()}
            logger.iter_toc()
            it = state.step
            history.append(dict(iter=it, **values, step_s=logger.iter_time.deque[-1],
                                wait_s=logger.data_time.deque[-1]))
            if it % cfg.DISPLAY_ITER == 0 or it == max_iter:
                logger.update_stats(values, it)
                logger.log_stats(it)
            if it % cfg.SOLVER.SNAPSHOT_ITERS == 0 or it == max_iter:
                checkpointer.save(state, it, snapshot=True)
                last_saved = it
    finally:
        batches.close()  # ends the loader's prefetch thread
    if last_saved != state.step:
        checkpointer.save(state, state.step)
    if world > 1:
        if not ranks_agree(model):
            raise RuntimeError(f"train_net: the {world} ranks' parameters differ at iter "
                               f"{state.step}; rank 0 wrote its own")
        say(f"train_net: the {world} ranks' parameters and buffers bit-equal at iter {state.step}")

    if history:
        peak = (f", peak device memory {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB"
                if device.type == "cuda" else "")
        ranks = (f" (rank 0 of {world}, {local_batch} of the batch's images each)"
                 if world > 1 else "")
        say(f"train_net: {len(history)} steps to iter {state.step}{ranks}: step wall time median "
            f"{statistics.median(r['step_s'] for r in history) * 1e3:.1f} ms, loader wait "
            f"median {statistics.median(r['wait_s'] for r in history) * 1e3:.1f} ms{peak} | "
            f"{device_name(device)}")
    say(f"training done at iter {state.step}")
    return history, state


if __name__ == "__main__":
    main(sys.argv[1:])
