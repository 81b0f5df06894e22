"""Auction-algorithm assignment for the Earth Mover's Distance (counterpart
of ``scanobjectnn_tpu/ops/emd.py``; the reference's
3DmFV-Net/utils/EMD/tf_auctionmatch_g.cu, which no training or evaluation
script calls).

The Jacobi auction (Bertsekas): every unassigned bidder (a point of
``xyz1``) bids for its best-value item (a point of ``xyz2``) at price +
(best − second best) + ε, and each item goes to its highest bidder (the
lowest index among equal bids).  ε = max(−min(benefit)/n, 1e-6) over the
whole batch, the benefit being −d², at most ``max_iters`` rounds; a bidder
left unassigned at the cap takes its greedy best item, which may duplicate
another's (an approximation, as in JAX, for the cap case only).  Plain
tensor ops on any device, one round a Python loop step (JAX runs the same
rounds under ``lax.while_loop``); not a kernel: the JAX package has no
Pallas kernel here.
"""

from __future__ import annotations

import torch

from scanobjectnn_torch.ops.grouping import pairwise_squared_distance

__all__ = ["auction_match", "emd_loss"]


def auction_match(xyz1: torch.Tensor, xyz2: torch.Tensor, max_iters: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """One-to-one assignment between two point sets of one size, [B, N, 3]
    each: (matchl, matchr) int32 [B, N], ``matchl[i]`` the ``xyz2`` item of
    ``xyz1`` bidder i, ``matchr[j]`` the bidder owning item j (-1 where none
    does at the cap).  No gradient."""
    b, n, _ = xyz1.shape
    benefit = -pairwise_squared_distance(xyz1.detach().float(), xyz2.detach().float())  # [B, bidders, items]
    eps = torch.clamp(-benefit.min() / n, min=1e-6)
    bidders = torch.arange(n, device=benefit.device, dtype=torch.int32)
    owner = torch.full((b, n), -1, dtype=torch.int32, device=benefit.device)  # per item: bidder or -1
    price = torch.zeros((b, n), dtype=torch.float32, device=benefit.device)
    neg_inf = torch.tensor(float("-inf"), device=benefit.device)

    def assigned(owner):  # per bidder: does some item name it (owners are unique)
        return (owner[:, :, None] == bidders).any(dim=1)

    for _ in range(max_iters):
        done = assigned(owner)
        if bool(done.all()):
            break
        value = benefit - price[:, None, :]
        best_item = value.argmax(dim=-1)  # [B, bidders], first of equal values
        picked = torch.nn.functional.one_hot(best_item, n).bool()
        best_val = value.gather(-1, best_item[..., None])[..., 0]
        second_val = torch.where(picked, neg_inf, value).amax(dim=-1)
        bid = torch.where(done, neg_inf, best_val - second_val + eps)
        bids = torch.where(picked, bid[:, :, None], neg_inf)  # [B, bidders, items]
        top_bid, top_bidder = bids.max(dim=1).values, bids.argmax(dim=1)
        taken = torch.isfinite(top_bid)
        owner = torch.where(taken, top_bidder.to(torch.int32), owner)
        price = torch.where(taken, price + top_bid, price)

    owns = owner[:, :, None] == bidders  # [B, items, bidders]
    matchl = owns.to(torch.int8).argmax(dim=1)
    matchl = torch.where(owns.any(dim=1), matchl, benefit.argmax(dim=-1))
    return matchl.to(torch.int32), owner


def emd_loss(xyz1: torch.Tensor, xyz2: torch.Tensor, max_iters: int = 256) -> torch.Tensor:
    """The mean euclidean distance between each ``xyz1`` point and its
    matched ``xyz2`` point: differentiable in both clouds through the
    (gradient-free) matching."""
    matchl, _ = auction_match(xyz1, xyz2, max_iters)
    matched = xyz2.gather(1, matchl.long()[..., None].expand(-1, -1, xyz2.shape[-1]))
    return torch.sqrt(torch.square(xyz1 - matched).sum(dim=-1)).mean()
