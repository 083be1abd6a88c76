"""Roofline analysis of the dry run's cells, on the card's ceilings.

Port of the JAX package's ``launch/roofline.py``.  Per (arch x shape) cell
of one mesh, three terms, each a lower bound on one rank's step:

    compute    = FLOPs / peak FLOP/s               (per rank)
    memory     = bytes / HBM rate                  (per rank, an estimate)
    collective = collective operand bytes / link rate

The term math is the serving profiler's
(:func:`repro_torch.obs.profile.roofline_terms`) and the ceilings are
:data:`repro_torch.hw.H100_SXM`'s or a fitted ``MachineModel``'s
(``--machine-model``).  A cell's collectives run on NVLink where every group
it counted fits one node (:data:`repro_torch.core.tiling.NVLINK_RANKS`
cards), else on the network (``hw.net_bw``): a ring over a larger group
crosses a node boundary, whose link is the slowest on the ring.  These are
datasheet ceilings, not measured.

Also per cell: the dominant term, the model FLOPs (``6 N D`` to train,
``2 N D`` to serve, ``N`` the active parameters, ``D`` the tokens) over the
cell's rank count against the counted FLOPs (the useful fraction), the
roofline fraction ``compute / max(terms)``, whether the rank's bytes fit
``hw.hbm_bytes``, and one line of advice.

Usage:
  python -m repro_torch.launch.roofline --inp results/dryrun_torch --out results/roofline_torch.md
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch import configs
from repro_torch import hw as hwlib
from repro_torch.core.tiling import NVLINK_RANKS
from repro_torch.obs.profile import roofline_terms

H100 = hwlib.H100_SXM
CHIPS_SINGLE = 256
RANKS = {"single": 256, "multi": 512}


def resolve_hw(spec: str | None):
    """Map a ``--machine-model`` flag onto the ceilings: ``None`` /
    ``"stock"`` -> the stock :data:`repro_torch.hw.H100_SXM`; a path -> the
    fitted :class:`repro_torch.characterize.model.MachineModel`'s card."""
    if spec is None or spec in ("stock", "none"):
        return H100
    from repro_torch.characterize import MachineModel
    return MachineModel.load(spec).h100()


def model_flops_for(arch_name: str, shape_name: str, *, phase: str) -> float:
    arch = configs.get(arch_name)
    cfg = arch.config
    sh = arch.shapes[shape_name]
    n_active = cfg.active_param_count()
    if phase == "train":
        tokens = sh.global_batch * sh.seq_len
        return 6.0 * n_active * tokens
    if phase == "prefill":
        tokens = sh.global_batch * sh.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * sh.global_batch


def advice(dom: str, cell: dict) -> str:
    if dom == "compute":
        return ("compute-bound: reduce remat recompute / fuse epilogues; "
                "already the desirable regime")
    if dom == "memory":
        if cell["phase"] == "decode":
            return ("memory-bound on weight+KV streaming: int8 weights, "
                    "MLA/ring caches, larger per-step batch amortization")
        return ("memory-bound: chunked vocab loss, wider fused blocks "
                "(DR1'), avoid re-materialized activations")
    return ("collective-bound: reshard to cut per-layer gathers (DR3'), "
            "overlap collectives with compute, compress cross-pod payloads")


def link_bw(cell: dict, hw) -> float:
    """The rate a cell's collectives run at: ``hw.nvlink_bw`` where every
    group the dry run counted holds at most :data:`NVLINK_RANKS` cards,
    else ``hw.net_bw``."""
    groups = [int(g) for s in cell.get("collectives", {}).values()
              for g in s.get("groups", {})]
    return hw.nvlink_bw if all(g <= NVLINK_RANKS for g in groups) \
        else hw.net_bw


def cell_ranks(cell: dict) -> int:
    """The ranks the cell's step runs on (its mesh's size)."""
    if cell.get("ranks"):
        return int(cell["ranks"])
    return RANKS.get(cell.get("mesh_kind", "single"), CHIPS_SINGLE)


def analyze_cell(cell: dict, *, hw=None) -> dict | None:
    if "skipped" in cell or "error" in cell:
        return None
    hw = hw if hw is not None else H100
    # Dry-run cells have no launch count, so the launch term stays zero.
    terms = roofline_terms(cell["flops"], cell["hlo_bytes"], 0, hw=hw,
                           collective_bytes=cell["collective_operand_bytes"],
                           link_bw=link_bw(cell, hw))
    dom = terms["bound"]
    mf = model_flops_for(cell["arch"], cell["shape"], phase=cell["phase"])
    mf_dev = mf / cell_ranks(cell)
    t_bound = terms["ceiling_s"]
    flops = cell["flops"]
    return {
        **{k: cell[k] for k in ("arch", "shape", "phase", "mesh_kind")},
        "t_compute_s": terms["t_compute_s"],
        "t_memory_s": terms["t_memory_s"],
        "t_collective_s": terms["t_collective_s"],
        "dominant": dom,
        "model_flops_per_dev": mf_dev,
        "useful_fraction": mf_dev / flops if flops else 0.0,
        "roofline_fraction": (terms["t_compute_s"] / t_bound if t_bound
                              else 0.0),
        "step_time_lower_bound_s": t_bound,
        "hbm_temp_gib": cell["temp_size_in_bytes"] / 2**30,
        "hbm_args_gib": cell["argument_size_in_bytes"] / 2**30,
        # donated buffers alias their outputs — count them once
        "fits_hbm": (cell["temp_size_in_bytes"]
                     + cell["argument_size_in_bytes"]
                     - cell.get("alias_size_in_bytes", 0)) <= hw.hbm_bytes,
        "advice": advice(dom, cell),
    }


def fmt_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | phase | compute s | memory s | collective s | "
           "dominant | MF/HLO | roofline frac | HBM GiB (temp+args) | fits |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['phase']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_fraction']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['hbm_temp_gib']:.1f}+{r['hbm_args_gib']:.1f} "
            f"| {'Y' if r['fits_hbm'] else 'N'} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--inp", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/roofline_torch.md")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--machine-model", default=None, metavar="MODEL_JSON",
                    help="fitted MachineModel artifact for the ceilings "
                         "(default: the stock H100 SXM datasheet constants)")
    args = ap.parse_args(argv)
    hw = resolve_hw(args.machine_model)

    rows, skips, errors = [], [], []
    for path in sorted(glob.glob(os.path.join(args.inp, "*.json"))):
        with open(path) as f:
            cell = json.load(f)
        if cell.get("mesh_kind", cell.get("mesh")) != args.mesh and \
                args.mesh not in str(cell.get("mesh", "")):
            continue
        if "skipped" in cell:
            skips.append(cell)
            continue
        if "error" in cell:
            errors.append(cell)
            continue
        r = analyze_cell(cell, hw=hw)
        if r:
            rows.append(r)
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    ranks = RANKS.get(args.mesh, CHIPS_SINGLE)
    out = [f"# Roofline table ({args.mesh} mesh, {ranks} cards, computed "
           f"on the NVIDIA H100 SXM datasheet's constants, not measured)",
           "", fmt_table(rows), "", "## Skipped cells", ""]
    for s in skips:
        out.append(f"- {s['arch']} x {s['shape']}: {s['skipped']}")
    if errors:
        out.append("\n## Errored cells\n")
        for e in errors:
            out.append(f"- {e['arch']} x {e['shape']} ({e.get('mesh')}): "
                       f"{e['error'][:200]}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {args.out}: {len(rows)} cells, {len(skips)} skips, "
          f"{len(errors)} errors")
    for r in rows:
        print(f"{r['arch']:20s} {r['shape']:12s} dom={r['dominant']:10s} "
              f"rf={r['roofline_fraction']:.2f} -> {r['advice']}")


if __name__ == "__main__":
    main()
