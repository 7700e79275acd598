"""Samplers: masks of the anchors a loss sees.

Port of `jdet_tpu/models/boxes/sampler.py` (`pseudo_sample` :14,
`_rank_select` :24, `random_sample` :49), over a leading batch
dimension.

`random_sample` draws one uniform per anchor for the positives and one
for the negatives, from `rand(shape)`: by default `torch.rand` on the
assignment's device from a `torch.Generator`, which the train step seeds
per iteration. JAX's random streams do not carry over, so a caller that
replays the reference's draws passes them through `rand`.
"""
from __future__ import annotations

import torch


def pseudo_sample(assign):
    """PseudoSampler: all positives, all negatives, as masks."""
    gt_inds = assign["gt_inds"]
    return {
        "pos_mask": gt_inds > 0,
        "neg_mask": gt_inds == 0,
        "gt_inds": gt_inds,
    }


def _rank_select(mask, num_expected, u, cap):
    """Of the True entries of mask (..., n), the `num_expected` (...,)
    whose uniforms u (..., n) are largest: the reference's rank of a
    random priority. `cap` bounds num_expected (the budget). Ties go to
    the lower index, as `jax.lax.top_k` and the reference's stable
    argsort break them, so the sort is stable."""
    pri = torch.where(mask, u, -1.0)
    order = torch.sort(pri, dim=-1, descending=True, stable=True).indices
    cap = min(cap, mask.shape[-1])
    head = order[..., :cap]
    take = torch.arange(cap, device=mask.device) < num_expected[..., None]
    sel = torch.zeros_like(mask).scatter(-1, head, take)
    return mask & sel


def random_sample(assign, num, pos_fraction, neg_pos_ub=-1, rand=None, generator=None):
    """RandomSampler with fixed budgets, per image of assign's (..., n)
    `gt_inds`: at most int(num * pos_fraction) positives, then negatives
    up to `num` in all (capped at neg_pos_ub times the positives if >= 0).

    The uniforms come from `rand(shape)` if given, else from `torch.rand`
    with `generator` on gt_inds' device: first (..., n) for the positives,
    then (..., n) for the negatives."""
    gt_inds = assign["gt_inds"]
    if rand is None:
        def rand(shape):
            return torch.rand(shape, generator=generator, device=gt_inds.device)

    pos_all = gt_inds > 0
    neg_all = gt_inds == 0
    u_pos = rand(tuple(gt_inds.shape))
    pos_cap = int(num * pos_fraction)
    pos_mask = _rank_select(pos_all, pos_all.sum(-1).clamp(max=pos_cap), u_pos, pos_cap)
    num_sampled_pos = pos_mask.sum(-1)

    num_expected_neg = num - num_sampled_pos
    if neg_pos_ub >= 0:
        ub = neg_pos_ub * num_sampled_pos.clamp(min=1)
        num_expected_neg = torch.minimum(num_expected_neg, ub)
    neg_mask = _rank_select(neg_all, num_expected_neg, rand(tuple(gt_inds.shape)), num)
    return {
        "pos_mask": pos_mask,
        "neg_mask": neg_mask,
        "gt_inds": gt_inds,
    }
