"""Extra sampling strategies.

The port's copy of cpm_tpu/data/samplers.py, after the reference's
pet/utils/data/samplers/:
  * RepeatFactorTrainingSampler (repeat_factor.py:9-158) — LVIS-style
    class-balanced repetition: images containing rare categories are
    repeated ceil-stochastically per epoch;
  * RangeSampler (range_sampler.py:5) — contiguous index range (the
    TestLoader start/end arguments play this role).
"""

import math
from collections import defaultdict
from typing import List

import numpy as np


def repeat_factors_from_category_frequency(
    dataset,
    repeat_thresh: float = 0.001,
    pow_: float = 0.5,
    max_repeat: float = 10000.0,
    min_repeat: float = 1.0,
) -> np.ndarray:
    """Per-image repeat factor r(I) = max over categories in I of the
    category-level factor max(MIN, min(MAX, (t / f(c)) ** POW))
    (repeat_factor.py:78-99; POW=0.5 is the LVIS-paper sqrt rule)."""
    cat_count = defaultdict(int)
    img_cats: List[set] = []
    for i in range(len(dataset)):
        _, labels = dataset.load_annotations(i)
        cats = set(int(c) for c in labels)
        img_cats.append(cats)
        for c in cats:
            cat_count[c] += 1
    n = len(dataset)
    cat_freq = {c: cnt / n for c, cnt in cat_count.items()}
    cat_rep = {
        c: max(min_repeat, min(max_repeat, math.pow(repeat_thresh / f, pow_)))
        for c, f in cat_freq.items()
    }
    rep = np.ones(n, np.float64)
    for i, cats in enumerate(img_cats):
        if cats:
            rep[i] = max(cat_rep[c] for c in cats)
    return rep


def repeat_factor_indices(
    repeat_factors: np.ndarray, epoch_seed: int
) -> np.ndarray:
    """Stochastic-ceil repetition per epoch (repeat_factor.py:100-130):
    image i appears floor(r_i) times plus one more with prob frac(r_i)."""
    g = np.random.RandomState(epoch_seed)
    int_part = np.floor(repeat_factors).astype(np.int64)
    frac = repeat_factors - int_part
    extra = (g.random_sample(len(repeat_factors)) < frac).astype(np.int64)
    reps = int_part + extra
    indices = np.repeat(np.arange(len(repeat_factors)), reps)
    g.shuffle(indices)
    return indices
