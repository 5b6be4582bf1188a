"""Command-line interface: ``python -m epnn_tpu_torch <command>``
(counterpart of ``epnn_tpu/cli.py``: the same eight subcommands, and every
flag with the JAX CLI's name, dest, type, choices and default).

  train         train a model on a directory of .xyz/.npy systems
  infer         predict charges for .xyz files (checkpoint or reference ckpt)
  import-ckpt   convert a reference TF checkpoint to the native format
  eval-pol      polarization-response analysis on a dimer
  horton2npy    extract MBIS charges from HORTON *-mtp.txt outputs
  convert-qm9   convert raw QM9 .xyz files to loader format
  export        export a serving artifact (``torch.export``)
  bench         benchmark inference on a system

The device: the commands run on the first CUDA card and raise when there
is none; ``EPNN_PLATFORM=cpu`` (the JAX CLI's platform switch) runs them
on the CPU, and ``cuda`` or ``gpu`` name the card.

``infer --atom-shard N`` / ``--ring-shard N`` serve on N devices, one
process each, started by torchrun:

    torchrun --nproc-per-node N -m epnn_tpu_torch infer ... --atom-shard N

(``EPNN_PLATFORM=cpu``: N gloo processes on the CPU).  Rank 0 writes the
outputs and prints; a world of another size than N exits naming it.
``train --data-parallel`` trains data-parallel over the world torchrun
started (a world of one without torchrun), and ``train --multihost``
joins the world of ``EPNN_COORDINATOR`` / ``EPNN_NUM_PROCESSES`` /
``EPNN_PROCESS_ID`` (or torchrun's variables) and trains over its
multi-host mesh; only rank 0 writes the checkpoints, the log and the
TensorBoard scalars:

    torchrun --nproc-per-node N -m epnn_tpu_torch train ... --data-parallel
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def platform_device():
    """The device of ``EPNN_PLATFORM``: ``"cpu"``, or None (the first CUDA
    card) when it is unset, ``cuda`` or ``gpu``; any other value exits."""
    platform = os.environ.get("EPNN_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return "cpu"
    if platform in ("", "cuda", "gpu"):
        return None
    raise SystemExit(f"EPNN_PLATFORM={platform!r}: use 'cpu', or 'cuda' / "
                     "'gpu' (or leave it unset) for the CUDA card")


def _add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--h-dim", type=int, default=48)
    p.add_argument("--e-dim", type=int, default=48)
    p.add_argument("--msg-dim", type=int, default=32)
    p.add_argument("--layers", type=int, nargs="+", default=[32, 32])
    p.add_argument("--rounds", "-T", type=int, default=5)
    p.add_argument("--n-elems", type=int, default=10,
                   help="atom feature width (10: 9-element table, 9: 8-element)")
    p.add_argument("--cutoff", type=float, default=3.0)
    p.add_argument("--eta", type=float, default=2.0)
    p.add_argument("--reference-compat", action="store_true",
                   help="reproduce the reference's unmasked GNN messages")
    p.add_argument("--preset",
                   choices=["model", "model2", "decay_model", "model_clean",
                            "model2_clean", "decay_model_clean"],
                   help="architecture preset: reference-named presets carry "
                        "the checkpoint's exact semantics (unmasked messages); "
                        "*_clean variants use pairwise-masked messages")


def _model_config(args):
    from epnn_tpu_torch.models import PRESETS, EPNNConfig

    if args.preset:
        cfg = PRESETS[args.preset]
    else:
        cfg = EPNNConfig(
            n_elems=args.n_elems, h_dim=args.h_dim, e_dim=args.e_dim,
            msg_dim=args.msg_dim, mlp_hidden=tuple(args.layers),
            T=args.rounds, cutoff=args.cutoff, eta=args.eta,
        )
    if args.reference_compat:
        cfg = cfg.replace(mask_messages=False)
    return cfg


def cmd_train(args):
    from epnn_tpu_torch.data import load_directory
    from epnn_tpu_torch.train import TrainConfig, train

    cfg = _model_config(args)
    mols = [m for m in load_directory(args.data) if m.labels is not None]
    print(f"{len(mols)} labeled systems from {args.data}")
    val_mols = None
    if args.val_data:
        val_mols = [m for m in load_directory(args.val_data)
                    if m.labels is not None]
        if not val_mols:
            raise SystemExit(
                f"--val-data {args.val_data}: no labeled systems found "
                "(needs .xyz files with matching .npy label arrays)")
        print(f"{len(val_mols)} labeled validation systems "
              f"from {args.val_data}")
    if args.init_from:
        # fine-tune: the checkpoint's config wins (arch must match weights)
        from epnn_tpu_torch.io import load_config

        cfg = load_config(args.init_from)
    # precision is a runtime policy, not part of the architecture
    if args.precision == "fast":
        cfg = cfg.replace(matmul_precision="default")
    elif args.precision == "parity":
        cfg = cfg.replace(matmul_precision="highest",
                          dense_matmul_precision="default")
    tc = TrainConfig(
        learning_rate=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        loss=args.loss, seed=args.seed, checkpoint_dir=args.out,
        log_path=os.path.join(args.out, "metrics.jsonl") if args.out else None,
        resume=args.resume, init_from=args.init_from,
        val_fraction=args.val_fraction, split_seed=args.split_seed,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        lr_final_fraction=args.lr_final_fraction,
        grad_clip_norm=args.grad_clip_norm, grad_accum=args.grad_accum,
        lr_plateau_factor=args.lr_plateau_factor,
        lr_plateau_patience=args.lr_plateau_patience,
        ema_decay=args.ema_decay, dump_predictions=args.dump_predictions,
        debug_nans=args.debug_nans, dense_max_atoms=args.dense_max_atoms,
        collapse_round1=not args.no_collapse_round1,
        far_cluster=args.far_cluster or 0,
        far_cluster_grad=args.far_cluster_grad != "stop",
        remat=args.remat, near_row_chunk=args.near_row_chunk,
        near_window=args.near_window, eval_every=args.eval_every,
        early_stop_patience=args.early_stop_patience,
        precompute_neighbors=not args.no_precompute_neighbors,
        tensorboard_dir=(os.path.join(args.out, "tb")
                         if args.out and args.tensorboard else None),
    )
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    device_type = "cpu" if args.device == "cpu" else None
    mesh = None
    if args.multihost:
        import dataclasses

        import torch.distributed as dist

        from epnn_tpu_torch.parallel import (
            initialize_distributed,
            is_coordinator,
            make_multihost_mesh,
        )

        initialize_distributed(device_type=device_type)
        mesh = make_multihost_mesh(device_type=device_type)
        print(f"multi-host mesh over {_mesh_shape(mesh)} "
              f"({dist.get_world_size()} processes, this is process "
              f"{dist.get_rank()})")
        if not is_coordinator():
            # the other ranks run the same steps but write no files
            tc = dataclasses.replace(tc, checkpoint_dir=None, log_path=None,
                                     tensorboard_dir=None)
    elif args.data_parallel:
        from epnn_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device_type=device_type)
        print(f"data-parallel over {_mesh_shape(mesh)} mesh")
    res = train(mols, cfg, tc, val_mols=val_mols, mesh=mesh,
                device=args.device)
    print(f"best val masked MAE: {res.best_val_masked_mae:.5f} e "
          f"(padded-metric equivalent: {res.best_val_padded_mae:.5f} e)")


def _mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a mesh, as JAX prints ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _make_predictor(args, **kw):
    """Predictor from --checkpoint / --reference-models on the CLI's
    device, with the CLI's precision policy applied:

    * parity — the near field and electron passing at "highest", the far
      field at "default" (the card's one-pass TF32 tier);
    * fast — "default" everywhere (conservation stays exact).
    """
    from epnn_tpu_torch.infer import Predictor

    if args.reference_models:
        src = Predictor.from_reference(args.reference_models,
                                       args.reference_name, device="cpu")
    elif args.checkpoint:
        src = Predictor.from_checkpoint(args.checkpoint, device="cpu")
    else:
        raise SystemExit("pass --checkpoint <dir> or --reference-models "
                         "<dir>")
    if args.precision == "fast":
        cfg = src.cfg.replace(matmul_precision="default")
    else:
        cfg = src.cfg.replace(matmul_precision="highest",
                              dense_matmul_precision="default")
    if args.compute_dtype is not None:
        # unconditional: an explicit --compute-dtype float32 also
        # overrides a bfloat16-configured checkpoint
        cfg = cfg.replace(compute_dtype=args.compute_dtype)
    return Predictor(params=src.params, cfg=cfg, device=args.device, **kw)


def _add_window_flags(p):
    """The huge-N gather knobs shared by infer and bench."""
    p.add_argument("--near-window", type=int, default=-1, metavar="W",
                   dest="near_window",
                   help="windowed huge-N gathers: each row chunk reads its "
                        "neighbors' rows from a window of W rows (the same "
                        "charges when W covers each chunk's neighbor-index "
                        "spread). -1 = auto (measured from the tables when "
                        "chunking is active), 0 = off")
    p.add_argument("--spatial-sort", choices=("auto", "on", "off"),
                   default="auto", dest="spatial_sort",
                   help="cell-sort atoms internally so windowed gathers "
                        "get compact windows (charges return in input "
                        "order; float summation order changes only). auto = "
                        "on from 16,384 padded atoms and for chunked huge "
                        "graphs")


def _is_coordinator() -> bool:
    from epnn_tpu_torch.parallel import is_coordinator

    return is_coordinator()


def _shard_kw(args) -> dict:
    """``mesh`` and ``shard_mode`` of ``--atom-shard N`` / ``--ring-shard
    N`` (ring where both are given, as the JAX CLI): a (1, N) mesh over
    the world of N processes torchrun started, on the CLI's device; {}
    without either flag.  A world of another size exits naming it,
    before any process group starts."""
    shard = args.atom_shard or args.ring_shard
    if not shard:
        return {}
    import torch.distributed as dist

    mode = "ring" if args.ring_shard else "atom"
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != shard:
        raise SystemExit(
            f"epnn_tpu_torch: --{mode}-shard {shard} runs one process per "
            f"device and the world size is {world}; start it as torchrun "
            f"--nproc-per-node {shard} -m epnn_tpu_torch infer ...")
    from epnn_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data=1, n_atoms=shard,
                     device_type="cpu" if args.device == "cpu" else None)
    if _is_coordinator():
        print(f"sharding the atom axis over {shard} devices ({mode} "
              "layout)")
    return dict(mesh=mesh, shard_mode=mode)


def cmd_infer(args):
    from epnn_tpu_torch.data import load_directory, load_molecule

    kw = _shard_kw(args)
    lead = not kw or _is_coordinator()
    if args.renormalize:
        kw["renormalize"] = True
    if args.no_collapse_round1:
        kw["collapse_round1"] = "off"
    if args.far_cluster:
        kw["far_cluster"] = args.far_cluster
    if args.near_row_chunk != -1:
        kw["near_row_chunk"] = args.near_row_chunk
    if args.near_window != -1:
        kw["near_window"] = args.near_window
    if args.spatial_sort != "auto":
        kw["spatial_sort"] = args.spatial_sort
    pred = _make_predictor(args, **kw)
    if os.path.isdir(args.path):
        mols = load_directory(args.path)
    else:
        mols = [load_molecule(args.path)]
    budget = args.far_budget
    if budget is not None:
        from epnn_tpu_torch.data import pad_molecules
        from epnn_tpu_torch.elements import table_for_n_elems

        big = max(mols, key=lambda m: m.natoms)
        cal = pred.calibrate_far_cluster(
            pad_molecules([big], table_for_n_elems(pred.cfg.n_elems),
                          pad_to=args.pad_to),
            budget=budget, apply=True)
        errs = ", ".join(f"C={c}: {e:.2e}" for c, e in
                         sorted(cal["errors"].items()))
        if lead and cal["selected"] is None:
            print(f"far-cluster calibration on {big.name}: no candidate "
                  f"meets {budget:g} e ({errs}) — serving exact")
        elif lead:
            print(f"far-cluster calibration on {big.name}: C="
                  f"{cal['selected']} (measured max|dq| "
                  f"{cal['errors'][cal['selected']]:.2e} e <= {budget:g}; "
                  f"{errs})")
    charges = pred.predict_molecules(mols, pad_to=args.pad_to)
    if not lead:
        return
    os.makedirs(args.out, exist_ok=True)
    for m, q in zip(mols, charges):
        np.save(os.path.join(args.out, m.name + "_pred.npy"), q)
        print(f"{m.name}: n={m.natoms} Q={m.total_charge:+.1f} "
              f"sum(q)={q.sum():+.5f}")
    print(f"wrote {len(mols)} prediction files to {args.out}")


def cmd_import_ckpt(args):
    from epnn_tpu_torch.io import import_checkpoint, save_params
    from epnn_tpu_torch.models import count_params

    params, cfg = import_checkpoint(args.prefix, e_dim=args.e_dim)
    save_params(args.out, params, cfg)
    print(f"imported {count_params(params)} params "
          f"(T={cfg.T}, n_elems={cfg.n_elems}) -> {args.out}")


def cmd_eval_pol(args):
    from epnn_tpu_torch.analysis import polarization_response
    from epnn_tpu_torch.data import load_molecule

    kw = {}
    if args.no_collapse_round1:
        kw["collapse_round1"] = "off"
    pred = _make_predictor(args, **kw)
    dimer = load_molecule(args.dimer)
    monomers = None
    if args.monomers:
        monomers = [load_molecule(p) for p in args.monomers]
    elif args.monomer_charges is None:
        raise SystemExit(
            "eval-pol: monomer net charges are physical inputs — pass "
            "--monomers <a.xyz> <b.xyz> (headers carry the charges) or "
            "--monomer-charges qA qB to split the dimer"
        )
    label = np.load(args.labels).reshape(-1) if args.labels else None
    res = polarization_response(
        pred, dimer, monomers=monomers,
        monomer_charges=args.monomer_charges,
        label_polarization=label,
        pad_to=args.pad_to,
    )
    print(res.summary())


def cmd_horton2npy(args):
    from epnn_tpu_torch.data.horton import convert_tree

    written = convert_tree(args.path, args.out)
    print(f"converted {len(written)} MBIS multipole files")


def cmd_convert_qm9(args):
    from epnn_tpu_torch.data.qm9 import convert_directory

    written = convert_directory(args.src, args.dst)
    print(f"converted {len(written)} raw QM9 files -> {args.dst}")


def cmd_export(args):
    from epnn_tpu_torch.data import load_molecule, pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.io.export_serving import export_predictor

    kw = {}
    if args.no_collapse_round1:
        kw["collapse_round1"] = "off"
    if args.far_cluster:
        kw["far_cluster"] = args.far_cluster
    pred = _make_predictor(args, **kw)
    mol = load_molecule(args.path)
    table = table_for_n_elems(pred.cfg.n_elems)
    batch = pad_molecules([mol], table, pad_to=args.pad_to)
    platforms = (tuple(args.platforms.split(","))
                 if args.platforms else None)
    manifest = export_predictor(pred, batch, args.out, mode=args.mode,
                                platforms=platforms)
    print(f"exported {manifest['mode']}-mode serving artifact "
          f"(B={manifest['batch_size']}, N={manifest['padded_atoms']}, "
          f"platforms={manifest['platforms']}) -> {args.out}")


def cmd_bench(args):
    from epnn_tpu_torch.data import load_molecule, pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems

    kw = {}
    if args.no_collapse_round1:
        kw["collapse_round1"] = "off"
    if args.neighbor_skin:
        kw["neighbor_skin"] = args.neighbor_skin
    if args.far_cluster:
        kw["far_cluster"] = args.far_cluster
    if args.near_row_chunk != -1:
        kw["near_row_chunk"] = args.near_row_chunk
    if args.near_window != -1:
        kw["near_window"] = args.near_window
    if args.spatial_sort != "auto":
        kw["spatial_sort"] = args.spatial_sort
    pred = _make_predictor(args, reuse_neighbors=args.reuse_neighbors, **kw)
    mol = load_molecule(args.path)
    batch = pad_molecules([mol], table_for_n_elems(pred.cfg.n_elems))
    # default: the serialized chain (one readback a loop); --per-call
    # times predict_batch call by call, host copies included
    stats = pred.benchmark_batch(
        batch, iters=args.iters, warmup_loops=args.warmup,
        profile_dir=args.profile_dir, per_call=args.per_call,
    )
    stats.update(natoms=mol.natoms, name=mol.name)
    if args.far_cluster:
        diag = pred.far_field_diagnostics(batch)
        stats.update(
            far_cluster=args.far_cluster,
            far_cluster_max_abs_dq=float(diag["max_abs_dq"].max()),
            far_cluster_radius=float(diag["max_radius"].max()),
        )
    print(json.dumps(stats))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="epnn_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train a model")
    _add_model_args(p)
    p.add_argument("--data", required=True)
    p.add_argument("--val-data", dest="val_data", default=None,
                   help="explicit validation directory (xyz+npy); when set, "
                        "ALL of --data trains and no random split happens")
    p.add_argument("--val-fraction", type=float, default=0.2,
                   dest="val_fraction",
                   help="random held-out fraction of --data when no "
                        "--val-data is given (default 0.2, split seed 42 — "
                        "the reference protocol)")
    p.add_argument("--out", default="runs/default")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--loss", choices=["masked_mse", "padded_mse"],
                   default="masked_mse")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-from",
                   help="fine-tune: initialize params (and config) from a "
                        "native checkpoint dir (e.g. from import-ckpt)")
    p.add_argument("--precision", choices=["keep", "fast", "parity"],
                   default="keep",
                   help="matmul precision POLICY for training (runtime "
                        "knob, not architecture): 'keep' (default) honors "
                        "the config/checkpoint; 'fast' forces 'default' "
                        "(the kernels' one-pass TF32 tier on the card); "
                        "'parity' forces the inference parity policy")
    p.add_argument("--dense-max-atoms", type=int, default=256,
                   help="buckets padded wider than this train through the "
                        "blockwise fused path (no dense pair tensors)")
    p.add_argument("--data-parallel", action="store_true",
                   help="data-parallel training over the world of "
                        "processes torchrun started (one a device)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed world (coordinator, "
                        "process count and rank from EPNN_COORDINATOR / "
                        "EPNN_NUM_PROCESSES / EPNN_PROCESS_ID or "
                        "torchrun's variables) and train data-parallel "
                        "over the global mesh; only rank 0 writes the "
                        "checkpoints and logs")
    p.add_argument("--no-collapse-round1", action="store_true",
                   help="disable the round-1 far-field collapse on fused "
                        "buckets (auto-verified per bucket; this flag pins "
                        "the uncollapsed summation order)")
    p.add_argument("--far-cluster", type=int, default=0, dest="far_cluster",
                   help="opt-in APPROXIMATE clustered far-field tier for "
                        "the TRAINING step on fused buckets (C weighted "
                        "k-means centroids replace each h!=0 round's "
                        "O(N^2) far field; eval + checkpoint selection stay "
                        "exact).  0 = exact")
    p.add_argument("--far-cluster-grad", choices=("exact", "stop"),
                   default="exact", dest="far_cluster_grad",
                   help="gradient mode of the clustered tier: 'exact' "
                        "(default) differentiates the final centroids "
                        "under the fixed assignment; 'stop' drops the "
                        "far-field dL/dpj path")
    p.add_argument("--no-precompute-neighbors", action="store_true",
                   help="rebuild neighbor lists inside every train/eval "
                        "step instead of once per bucket (audit mode; the "
                        "per-bucket tables are the same)")
    p.add_argument("--remat", action="store_true",
                   help="recompute message/pass rounds in the fused "
                        "training backward (bounds activation memory at "
                        "one round's state)")
    p.add_argument("--near-row-chunk", type=int, default=-1,
                   dest="near_row_chunk", metavar="ROWS",
                   help="huge-N training memory mode: run each round's "
                        "(N, k, ·) near-field activations in chunks of ROWS "
                        "rows.  -1 (default) = auto: buckets >= 200,000 "
                        "padded atoms chunk with the balanced policy and "
                        "force remat for themselves; 0 = off; explicit ROWS "
                        "requires --remat")
    p.add_argument("--near-window", type=int, default=0,
                   dest="near_window", metavar="W",
                   help="windowed huge-N near gathers for the chunked "
                        "training path (requires --near-row-chunk and "
                        "spatially sorted atoms with window width <= W "
                        "— see ops.fused.neighbor_window_width)")
    p.add_argument("--eval-every", type=int, default=1, dest="eval_every",
                   help="evaluate the validation set every Nth epoch only "
                        "(the final epoch always evaluates; skipped epochs "
                        "log val metrics as null and never update the best "
                        "checkpoint)")
    p.add_argument("--lr-schedule", choices=("constant", "cosine"),
                   default="constant", dest="lr_schedule",
                   help="LR schedule (cosine: ROADMAP item 9.2, not ported "
                        "yet)")
    p.add_argument("--warmup-steps", type=int, default=0,
                   dest="warmup_steps",
                   help="linear LR warmup steps (cosine schedule only)")
    p.add_argument("--lr-final-fraction", type=float, default=0.05,
                   dest="lr_final_fraction",
                   help="cosine floor as a fraction of the peak LR")
    p.add_argument("--ema-decay", type=float, default=None, dest="ema_decay",
                   help="exponential moving average of the weights "
                        "(ROADMAP item 9.2, not ported yet)")
    p.add_argument("--lr-plateau-factor", type=float, default=None,
                   dest="lr_plateau_factor",
                   help="reduce-on-plateau LR factor (ROADMAP item 9.2, not "
                        "ported yet)")
    p.add_argument("--lr-plateau-patience", type=int, default=2,
                   dest="lr_plateau_patience",
                   help="evaluated epochs without improvement before each "
                        "plateau LR reduction (default 2)")
    p.add_argument("--grad-accum", type=int, default=1, dest="grad_accum",
                   help="accumulate gradients over N minibatches (N > 1: "
                        "ROADMAP item 9.2, not ported yet)")
    p.add_argument("--grad-clip-norm", type=float, default=None,
                   dest="grad_clip_norm",
                   help="global-norm gradient clipping (ROADMAP item 9.2, "
                        "not ported yet)")
    p.add_argument("--split-seed", type=int, default=42, dest="split_seed",
                   help="random-split seed (default 42, the reference "
                        "protocol)")
    p.add_argument("--dump-predictions", action="store_true",
                   dest="dump_predictions",
                   help="dump train/val prediction+label+name arrays next "
                        "to the best checkpoint on every improvement (the "
                        "reference's model_systems/ artifact protocol)")
    p.add_argument("--debug-nans", action="store_true", dest="debug_nans",
                   help="NaN checking (ROADMAP item 9.5, not ported yet)")
    p.add_argument("--early-stop-patience", type=int, default=None,
                   dest="early_stop_patience",
                   help="stop when the val masked MAE has not improved for "
                        "this many consecutive EVALUATED epochs (default: "
                        "run all epochs, the reference protocol)")
    p.add_argument("--tensorboard", action="store_true",
                   help="TensorBoard event files under <out>/tb (ROADMAP "
                        "item 9.5, not ported yet)")
    p.set_defaults(fn=cmd_train)

    def _ckpt_args(p):
        p.add_argument("--checkpoint", help="native checkpoint dir")
        p.add_argument("--reference-models",
                       help="reference models/ dir (TF checkpoints)")
        p.add_argument("--reference-name", default="decay_model")
        p.add_argument("--precision", choices=["parity", "fast"],
                       default="parity",
                       help="parity: the near field and electron passing at "
                            "'highest' (3xTF32 on the card), the far field "
                            "at 'default' (one TF32 pass); fast: 'default' "
                            "everywhere (conservation stays exact)")
        p.add_argument("--no-collapse-round1", action="store_true",
                       help="disable the round-1 far-field collapse (auto-"
                            "detected per batch); this flag pins the "
                            "uncollapsed summation order")
        p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                       default=None, dest="compute_dtype",
                       help="activation dtype for the forward (default: "
                            "keep the checkpoint config); the electron-"
                            "passing rounds stay float32 for exact "
                            "antisymmetry regardless")

    p = sub.add_parser("infer", help="predict charges")
    _ckpt_args(p)
    p.add_argument("path", help=".xyz file or directory")
    p.add_argument("--out", default="predictions")
    p.add_argument("--pad-to", type=int)
    p.add_argument("--atom-shard", type=int, default=0, metavar="N",
                   help="shard each graph's pair grid over N devices, one "
                        "process each (run under torchrun --nproc-per-node "
                        "N)")
    p.add_argument("--ring-shard", type=int, default=0, metavar="N",
                   help="shard atoms over N devices in a ring, one "
                        "process each (run under torchrun --nproc-per-node "
                        "N)")
    p.add_argument("--renormalize", action="store_true",
                   help="redistribute the fp conservation residue uniformly "
                        "over real atoms: sum(q) matches the net charge to "
                        "fp ulp (residue/n_real per-atom shift)")
    p.add_argument("--far-cluster", type=int, default=0, metavar="C",
                   help="APPROXIMATE clustered far-field serving tier: "
                        "each message round's O(N^2) beyond-cutoff "
                        "reduction over C weighted k-means centroids "
                        "(O(N*C)).  Near field + electron passing stay "
                        "exact, so conservation is untouched; quantify the "
                        "error with Predictor.far_field_diagnostics. 0 = "
                        "exact")
    p.add_argument("--far-budget", type=float, default=None, metavar="E",
                   help="auto-calibrate the clustered tier: measure "
                        "max|dq| vs the exact forward on the LARGEST input "
                        "molecule at ascending C (16,32,64,128,256) and "
                        "serve with the smallest C within E (in e); falls "
                        "back to exact when none qualifies")
    p.add_argument("--near-row-chunk", type=int, default=-1, metavar="R",
                   dest="near_row_chunk",
                   help="huge-N memory mode: run the (N,k,.) near-field "
                        "activations and the cell builder's candidate "
                        "scoring in chunks of R rows (the same charges, "
                        "bounded memory). -1 = auto (on from 200,000 "
                        "padded atoms), 0 = off")
    _add_window_flags(p)
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("import-ckpt", help="TF checkpoint -> native format")
    p.add_argument("prefix", help="TF checkpoint prefix")
    p.add_argument("--out", required=True)
    p.add_argument("--e-dim", type=int, default=48)
    p.set_defaults(fn=cmd_import_ckpt)

    p = sub.add_parser("eval-pol", help="polarization-response analysis")
    _ckpt_args(p)
    p.add_argument("dimer", help="dimer .xyz (with splits metadata)")
    p.add_argument("--monomers", nargs=2,
                   help="monomer .xyz files (headers carry the net charges)")
    p.add_argument("--monomer-charges", nargs=2, type=float,
                   help="monomer net charges (required when splitting the "
                        "dimer without --monomers)")
    p.add_argument("--labels", help="label polarization .npy")
    p.add_argument("--pad-to", type=int)
    p.set_defaults(fn=cmd_eval_pol)

    p = sub.add_parser("horton2npy", help="extract MBIS charges")
    p.add_argument("path")
    p.add_argument("--out")
    p.set_defaults(fn=cmd_horton2npy)

    p = sub.add_parser("convert-qm9", help="raw QM9 -> loader format")
    p.add_argument("src")
    p.add_argument("dst")
    p.set_defaults(fn=cmd_convert_qm9)

    p = sub.add_parser(
        "export", help="export a serving artifact (torch.export)")
    _ckpt_args(p)
    p.add_argument("path", help=".xyz file fixing the serving geometry "
                               "class")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--pad-to", type=int,
                   help="padded atom width of the artifact (default: the "
                        "molecule's natoms rounded up)")
    p.add_argument("--mode", choices=["dense", "blocked", "md"],
                   default=None,
                   help="calling convention (default: the Predictor's own "
                        "dispatch for this size; 'md' adds precomputed "
                        "(idx, nbr_mask) neighbor-table inputs)")
    p.add_argument("--platforms",
                   help="comma-separated platforms of the artifact, "
                        "'cpu' and/or 'cuda' (default: the device it is "
                        "exported on); the kernels' operators run the "
                        "kernels on the card, their plain versions on "
                        "the CPU")
    p.add_argument("--far-cluster", type=int, default=0, metavar="C",
                   help="bake the APPROXIMATE clustered far-field tier "
                        "into the artifact (see `infer --far-cluster`)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("bench", help="benchmark inference")
    _ckpt_args(p)
    p.add_argument("path", help=".xyz file")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--profile-dir")
    p.add_argument("--reuse-neighbors", action="store_true",
                   help="serving/MD mode: build the neighbor list once and "
                        "reuse it every iteration (the same charges)")
    p.add_argument("--neighbor-skin", type=float, default=0.0,
                   help="Verlet-skin MD serving (needs --reuse-neighbors): "
                        "select once at cutoff+skin, re-gather only the "
                        "O(N*k) pair distances each step until any atom "
                        "drifts past skin/2 (exact charges)")
    p.add_argument("--per-call", action="store_true",
                   help="time predict_batch call by call, the device "
                        "synchronized after each, instead of the serialized "
                        "chain with one readback a loop")
    p.add_argument("--far-cluster", type=int, default=0, metavar="C",
                   help="benchmark the APPROXIMATE clustered far-field tier "
                        "with C centroids (see `infer --far-cluster`); the "
                        "printed JSON adds the measured max |dq| vs the "
                        "exact forward on the same geometry")
    p.add_argument("--near-row-chunk", type=int, default=-1, metavar="R",
                   dest="near_row_chunk",
                   help="huge-N memory mode (see `infer --near-row-chunk`); "
                        "-1 = auto, 0 = off")
    _add_window_flags(p)
    p.set_defaults(fn=cmd_bench)

    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.device = platform_device()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
