"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, run after the window.

The program's first ``check_steps`` train steps run in set-up, through the
same call and feed as the window's (``program.step_call``), from the
benchmark's weights. The reference redoes them from the same weights, the
same seed and the same traffic: it draws the same ids (its own alias table
and a generator seeded as the program's sampler is), the same head
dropout masks, and runs its own forward, loss, backward and AdamW. Then:

  * ``loss_gap``: the largest relative gap of a step's loss;
  * ``grad_gap``: the first gradient (the program's from its optimizer's
    state after step 1), by the worst leaf: the gap between the program's
    norm and the reference's, over the larger of the reference's norm of
    that leaf and of the median leaf;
  * ``change_gap``: the same of each leaf's change after the last check
    step;
  * ``valid_gap``: the program's validation logits after the window, from
    its own evaluation, against the reference's eval forward on the
    program's final weights and statistics (the reference follows the
    program's state here: the steps between are the window's), largest
    gap over the largest reference logit. Where a model takes an argmax
    (kgnn), only molecules whose every best score leads the second by more
    than ``tie_margin`` are compared (``valid_compared`` counts them):
    at a near tie, another order of summation picks another ordering.

Leaves whose reference gradient is under a thousandth of the median
leaf's (no path to the loss) are left out of both leaf numbers.

kgnn's bond supports start equal across each kernel's slots, so the
steps' forward does not depend on which bond a neighbour is paired with:
a wrong pairing shows in ``valid_gap``, once the window's steps have moved
the slots apart (``control.bond_slots_rolled``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench_port.reference.common import (
    AdamW,
    IdSampler,
    bce_loss,
    dropout_keep,
    learning_rate,
)

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "valid_gap",
           "valid_compared")


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].double())
                         for n in names]).cpu().numpy()
    return dict(zip(names, norms.tolist()))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep,
             med: float) -> float:
    """The worst leaf's gap of norms, each over the larger of the
    reference's norm of the leaf and ``med``, the median leaf's."""
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300)
               for n in keep)


def reference_steps(ref, cfg: dict, tspec: dict, traffic, weights, seed: int,
                    device, steps: int):
    """(losses, first gradients' norms, changes' norms) of the reference's
    first ``steps`` train steps, and its parameters after them."""
    opt = cfg["optimizer"]
    train = np.asarray(traffic.split["train"])
    sampler = IdSampler(seed, train, traffic.labels[train], device)
    drop = torch.Generator(device=device)
    drop.manual_seed(seed)
    prm = {n: w.detach().clone().requires_grad_(True)
           for n, w in weights.items()}
    adam = AdamW(prm, opt["weight_decay"])
    batch = tspec["batch_size"]
    total = -(-len(train) // batch) * tspec["schedule_epochs"] + 2
    rate = cfg["head"]["ffn_dropout_rate"]
    width = ref.embedding_width(cfg)
    dtype = next(iter(weights.values())).dtype
    losses, first = [], None
    for k in range(steps):
        ids = sampler.draw(batch).cpu().numpy()
        keep = (dropout_keep(drop, (batch, width), rate, dtype, device)
                if rate else None)
        inp = ref.inputs(traffic.molecules, traffic.mol_of_entry[ids],
                         traffic.labels[ids], device, cfg, dtype)
        for p in prm.values():
            p.grad = None
        logits, _ = ref.forward(prm, inp, cfg, train=True, head_keep=keep)
        loss = bce_loss(logits, inp["y"])
        loss.backward()
        losses.append(float(loss.detach()))
        if k == 0:
            first = leaf_norms({n: p.grad if p.grad is not None
                                else torch.zeros_like(p)
                                for n, p in prm.items()})
        adam.step(learning_rate(adam.count, opt["peak_lr"], opt["end_lr"],
                                opt["warmup_iterations"], total))
    change = leaf_norms({n: prm[n].detach() - weights[n] for n in prm})
    return losses, first, change, {n: p.detach() for n, p in prm.items()}


def reference_valid(ref, cfg: dict, traffic, ids: np.ndarray, state, device,
                    block: int = 1024):
    """(logits, margins) of the reference's eval forward over entries
    ``ids`` with the parameters and statistics ``state``."""
    prm = {n: state[n].to(device) for n in
           (s[0] for s in ref.param_specs(cfg))}
    dtype = next(iter(prm.values())).dtype
    stats = ref.eval_stats(state, device)
    logits, margins = [], []
    with torch.no_grad():
        for s in range(0, len(ids), block):
            part = ids[s:s + block]
            inp = ref.inputs(traffic.molecules, traffic.mol_of_entry[part],
                             traffic.labels[part], device, cfg, dtype)
            lg, mg = ref.forward(prm, inp, cfg, train=False, bn_stats=stats)
            logits.append(lg.double().cpu().numpy())
            margins.append(mg.double().cpu().numpy())
    return np.concatenate(logits), np.concatenate(margins)


def compare(prog: dict, refr: dict, limits: dict) -> Dict[str, float]:
    """The numbers compared, from the program's readings ``prog`` and the
    reference's ``refr`` (each: losses, first, change, valid logits; the
    reference also its valid margins). ``limits`` gives the
    ``tie_margin``."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-300)
                   for a, b in zip(prog["losses"], refr["losses"]))
    if not all(np.isfinite(v) for v in prog["losses"]):
        loss_gap = float("inf")
    med = float(np.median(list(refr["first"].values())))
    keep = [n for n, v in refr["first"].items() if v >= 1e-3 * med]
    out = {"loss_gap": loss_gap}
    for name, key in (("grad", "first"), ("change", "change")):
        norm = float(np.median([refr[key][n] for n in keep]))
        out[f"{name}_gap"] = leaf_gap(prog[key], refr[key], keep, norm)
    clear = refr["margins"] > limits["tie_margin"]
    if clear.any():
        scale = float(np.abs(refr["valid"][clear]).max())
        out["valid_gap"] = float(np.abs(prog["valid"][clear]
                                        - refr["valid"][clear]).max()) / max(
            scale, 1e-300)
    else:
        out["valid_gap"] = float("inf")
    out["valid_compared"] = float(clear.mean())
    return out


def verdict(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each number beside its limit: the gaps may not pass theirs, the
    share of validation molecules compared may not fall under its own."""
    out = {}
    for name in NUMBERS:
        value, limit = numbers[name], limits[name]
        ok = value >= limit if name == "valid_compared" else value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
