"""A configuration file, made into the port's config and model and into the
reference's.

A configuration (`benchmark/configs/<name>.json`) names a builder of the
port's `config` module and the keys it sets over it. The port's config
comes from `cpm_tpu_torch.config`, the reference's from its own frozen copy
(`benchmark.reference.config`): the same names, neither reading the other.
Both models are built on the meta device and then given the benchmark's
state dict, so no weight is drawn on the host.
"""

import torch


def apply_keys(cfg, keys: dict):
    """Set each dotted key of `keys` on `cfg`; a JSON list becomes a tuple
    where the key holds a tuple. An unknown key raises."""
    for dotted, value in keys.items():
        node = cfg
        *path, leaf = dotted.split(".")
        for p in path:
            node = node[p]
        if leaf not in node:
            raise KeyError(f"config key {dotted} does not exist")
        if isinstance(node[leaf], tuple) and isinstance(value, list):
            value = tuple(value)
        node[leaf] = value
    return cfg


def make_config(spec: dict, config_module, train_images: int = 0):
    """The config of `spec` from `config_module` (the port's or the
    reference's). For a training cell of `train_images` images a step,
    TRAIN.BATCH_SIZE is that number and SOLVER.BASE_LR scales from the
    spec's `lr_batch` images by the linear rule."""
    cfg = getattr(config_module, spec["builder"])(**spec.get("builder_args", {}))
    apply_keys(cfg, spec.get("set", {}))
    if train_images:
        cfg.TRAIN.BATCH_SIZE = int(train_images)
        cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * train_images / float(spec["lr_batch"])
    return cfg


def meta_model(model_class, cfg):
    with torch.device("meta"):
        return model_class(cfg)


def on_device(meta, state: dict, device):
    """`meta` made real on `device` in channels_last memory, holding
    `state`."""
    model = meta.to_empty(device=device).to(memory_format=torch.channels_last)
    model.load_state_dict(state)
    return model


def program_model(cfg, state: dict, device):
    """The port's model for `cfg` holding `state`, its pooler backend set
    from the config as the port's `build_model` sets it."""
    from cpm_tpu_torch.modeling.model import GeneralizedRCNN
    from cpm_tpu_torch.ops import pooler

    pooler.set_pooler_backend(getattr(cfg.TPU, "POOLER_KERNEL", "auto"))
    return on_device(meta_model(GeneralizedRCNN, cfg), state, device)


def reference_meta(cfg):
    from benchmark.reference.modeling.model import GeneralizedRCNN

    return meta_model(GeneralizedRCNN, cfg)
