"""The readings the check's limits are set from, and the faults it must see.

    python3 -m bench_port.control --workload <name> --seeds 1,2,3 \
        [--what sound,control,faults|<fault>] \
        [--seconds 0.5]

On the card, at the cell's own size, one process for all seeds. For each
seed it prints one JSON line a reading:

  * ``sound``: a run of the cell (``run.run_cell``, a short window);
  * ``control``: the plain reference put in the program's place and
    computed with TF32 products (the precision below the configuration's
    fp32 with TF32 off), against the reference in fp32: the same steps,
    and the validation logits of the TF32 reference's state after them
    (statistics 0 and 1);
  * ``faults``: the program with a fault planted under the timed path:
    half of each batch left out of the loss (``half_batch``), one block
    of validation answers altered where the Trainer's block scorer
    produces them (``altered_answers``), and, in kgnn, each neighbour's
    bond paired with the next neighbour's (``bond_slots_rolled``: a wrong
    bond-slot mapping, which the first steps cannot see while a kernel's
    bond supports are equal across its slots). A step that leaves the
    state unchanged (``state_unchanged``) reads 1 by the leaf measure and
    needs no run; the CPU tests plant it.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from bench_port import check, files, traffic as traffic_mod
from bench_port.reference.common import make_weights


def half_batch(tr) -> None:
    """The loss takes the mean over the first half of each batch only."""
    loss, half = tr.loss_fn, tr.config.batch_size // 2
    tr.loss_fn = lambda p, y, m: loss(p[:half], y[:half], m[:half])


def state_unchanged(tr) -> None:
    """The optimizer's step leaves the parameters and its state as they
    were."""
    tr.optimizer.step = lambda lr, apply=None: None


def altered_answers(tr) -> None:
    """The first block of every evaluation comes back with each answer
    moved by 1."""
    scorer = tr._blocks

    class Altered:
        def __call__(self, *args, **kwargs):
            out = scorer(*args, **kwargs).clone()
            out[0] += 1.0
            return out

    tr._blocks = Altered()


def bond_slots_rolled(tr) -> None:
    """Each scored node's bond features reach its kernel convolutions one
    slot over: neighbour j is paired with neighbour j + 1's bond (mod d)."""
    convs = [m for m in tr.model.modules() if hasattr(m, "edge_attr_support")]
    if not convs:
        raise ValueError("the model scores no bonds")
    for mod in convs:
        def rolled(*args, _forward=mod.forward, **kwargs):
            kwargs["e_nei"] = kwargs["e_nei"].roll(1, 1)
            return _forward(*args, **kwargs)

        mod.forward = rolled


FAULTS = {"half_batch": half_batch, "altered_answers": altered_answers,
          "bond_slots_rolled": bond_slots_rolled}


def control_numbers(workload: str, seed: int, device="cuda") -> dict:
    """The check's numbers with the TF32 reference in the program's
    place."""
    cell = files.cell(files.benchmark(), workload)
    cfg = files.config(cell["config"])
    tspec = files.traffic(cell["traffic"])
    limits = files.limits(workload)
    ref = files.reference(cfg["family"])
    seed = int(seed) % 2 ** 63
    dev = torch.device(device)
    data = traffic_mod.make_traffic(tspec, seed)
    weights = make_weights(ref.param_specs(cfg), seed, dev)
    ids = np.asarray(data.split["valid"])
    out = {}
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        losses, first, change, after = check.reference_steps(
            ref, cfg, tspec, data, weights, seed, dev, tspec["check_steps"])
        if tf32:
            state = dict({n: t.cpu() for n, t in after.items()},
                         **ref.initial_stats(cfg))
        valid, margins = check.reference_valid(ref, cfg, data, ids, state,
                                               dev)
        out[tf32] = {"losses": losses, "first": first, "change": change,
                     "valid": valid, "margins": margins}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = check.compare(out[True], out[False], limits)
    return {"numbers": numbers,
            "leaves": {n: [out[True]["first"][n], out[False]["first"][n],
                           out[True]["change"][n], out[False]["change"][n]]
                       for n in sorted(out[False]["first"])}}


def main(argv=None) -> int:
    from bench_port import run

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="sound,control,faults")
    p.add_argument("--seconds", type=float, default=0.5)
    args = p.parse_args(argv)
    what = args.what.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        readings = []
        if "sound" in what:
            readings.append(("sound", lambda: run.run_cell(
                args.workload, seed, args.seconds, False)["info"]))
        if "control" in what:
            readings.append(("control", lambda: control_numbers(
                args.workload, seed)))
        for name, fault in FAULTS.items():
            if "faults" in what or name in what:
                readings.append((name, lambda f=fault: run.run_cell(
                    args.workload, seed, args.seconds, False,
                    tamper=f)["info"]))
        for kind, read in readings:
            try:
                info = read()
            except ValueError as e:  # a fault the model cannot have
                info = {"not_planted": str(e)}
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": kind, **info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
