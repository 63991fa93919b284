"""Vectorized anchor/proposal <-> ground-truth matcher.

Port of cpm_tpu/utils/matcher.py: argmax over the gt axis (the first gt on
ties), BELOW_LOW (-1) / BETWEEN (-2) sentinels and the low-quality-match
recovery pass, on fixed shapes; padded gt rows can never match.
"""

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_boxes(
    quality: torch.Tensor,
    gt_mask: torch.Tensor,
    high_threshold: float,
    low_threshold: float,
    allow_low_quality_matches: bool = False,
) -> torch.Tensor:
    """Match each of N predictions to one of M (padded) ground truths.

    Args:
      quality: [..., M, N] pairwise match quality (IoU), rows = gt.
      gt_mask: [..., M] bool; False rows are padding.
      allow_low_quality_matches: restore, for each gt, every prediction
        tied at that gt's best quality to its argmax gt.

    Returns: matches [..., N] int32: a gt index in [0, M) or a sentinel.
    """
    neg_inf = torch.finfo(quality.dtype).min
    q = torch.where(gt_mask[..., :, None], quality, neg_inf)
    matched_vals, all_matches = torch.max(q, dim=-2)
    all_matches = all_matches.to(torch.int32)

    below_low = matched_vals < low_threshold
    between = (matched_vals >= low_threshold) & (matched_vals < high_threshold)
    matches = torch.where(below_low, BELOW_LOW_THRESHOLD, all_matches)
    matches = torch.where(between, BETWEEN_THRESHOLDS, matches)

    if allow_low_quality_matches:
        highest_per_gt = torch.amax(q, dim=-1, keepdim=True)
        is_best = (q == highest_per_gt) & gt_mask[..., :, None]
        recovered = torch.any(is_best, dim=-2)
        matches = torch.where(recovered, all_matches, matches)
    return matches
