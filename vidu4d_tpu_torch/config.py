"""Command-line configuration without absl (`vidu4d_tpu/config.py`).

One table of the JAX package's flags (`config.py:20-221`: TrainModelConfig,
TrainOptConfig, GaussianConfig, ReferenceCompatConfig) with the same names,
types and defaults, the flags of the render / export / reanimate CLIs, and
a parser of absl's command-line and flagfile syntax on the standard library:

- ``--name=value`` and ``--name value``;
- booleans as ``--name``, ``--noname`` and ``--name=true|false|1|0``;
- comma-separated lists;
- ``--flagfile=PATH`` (recursively), expanded in place, so later flags
  override earlier ones.

The static 2DGS and metrics CLIs add their own tables (``GS_STATIC_FLAGS``,
``METRICS_FLAGS``).

An ``opts.log`` written by the JAX ``save_config()`` also holds absl's own
flags (``--verbosity``, ``--logtostderr``, ...); those are ignored. Any
other flag the table does not know raises.

``save_config`` writes the training flags as ``--name=value`` lines that the
JAX ``load_flags_from_file`` reads back. The port's own entry-point flag
(``ENTRY_FLAGS``: ``--device``) is not written: the JAX CLIs would reject
it.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

F, I, S, B, L = "float", "integer", "string", "bool", "list"

# the JAX package's flags, in its order (`config.py:20-221`)
TRAIN_FLAGS: Dict[str, Tuple[str, object]] = {
    # TrainModelConfig (:21-61)
    "mask_wt": (F, 0.1), "rgb_wt": (F, 0.1), "depth_wt": (F, 1e-4), "flow_wt": (F, 0.5),
    "flow_noise_px": (F, 2.5), "vis_wt": (F, 1e-2), "feature_wt": (F, 1e-2),
    "feat_reproj_wt": (F, 5e-2), "reg_visibility_wt": (F, 1e-4),
    "reg_eikonal_wt": (F, 1e-3), "reg_deform_cyc_wt": (F, 0.01), "cycle_subsample": (I, 4),
    "reg_delta_skin_wt": (F, 5e-3), "reg_skin_entropy_wt": (F, 5e-4),
    "reg_gauss_skin_wt": (F, 1e-3), "reg_cam_prior_wt": (F, 0.1),
    "reg_skel_prior_wt": (F, 0.1), "reg_gauss_mask_wt": (F, 0.01),
    "reg_soft_deform_wt": (F, 100.0), "field_type": (S, "fg"), "fg_motion": (S, "rigid"),
    "single_inst": (B, True), "rgb_timefree": (B, False), "rgb_dirfree": (B, False),
    "use_wide_near_far": (B, False),
    # TrainOptConfig (:64-89)
    "seqname": (S, "cat"), "logname": (S, "tmp"), "data_prefix": (S, "crop"),
    "train_res": (I, 256), "logroot": (S, "logdir/"), "load_suffix": (S, ""),
    "feature_type": (S, "dinov2"), "load_path": (S, ""), "learning_rate": (F, 5e-4),
    "num_rounds": (I, 20), "iters_per_round": (I, 200), "imgs_per_gpu": (I, 256),
    "pixels_per_image": (I, 16), "reset_steps": (B, True), "no_loss_mask": (B, False),
    "ngpu": (I, 1), "num_workers": (I, 0), "eval_res": (I, 128), "save_freq": (I, 10),
    "profile": (B, False),
    # GaussianConfig (:92-148)
    "gs_optim_warp": (B, True), "gs_learnable_bg": (B, True),
    "intrinsics_lr_mult": (F, 1.0), "arap_wt": (F, 0.0), "rgb_loss_only": (B, False),
    "quant_exp": (B, False), "force_center_cam": (B, False), "reg_in_cano": (B, False),
    "lambda_dist": (F, 0.0), "lambda_normal": (F, 0.05), "reg_volume_loss_wt": (F, 0.0),
    "maskloss_no_vis2d": (B, False), "sh_degree": (I, 3), "white_background": (B, False),
    "iterations": (I, 30000), "position_lr_init": (F, 0.00005),
    "position_lr_final": (F, 0.0000016), "position_lr_delay_mult": (F, 0.01),
    "position_lr_max_steps": (I, 30000), "feature_lr": (F, 0.0025),
    "opacity_lr": (F, 0.05), "scaling_lr": (F, 0.005), "rotation_lr": (F, 0.001),
    "regist_feat_lr": (F, 0.0025), "percent_dense": (F, 0.01), "lambda_dssim": (F, 0.0),
    "densification_interval": (I, 100), "opacity_reset_interval": (I, 3000),
    "outlier_filtering_interval": (I, 2000), "outlier_stop_iter": (I, 29000),
    "densify_from_iter": (I, 500), "densify_until_iter": (I, 15000),
    "densify_grad_threshold": (F, 0.0002), "gs_init_mesh": (S, ""), "gs_init_ply": (S, ""),
    "gs_capacity": (I, 400000), "raster_tile": (I, 16), "raster_span_cap": (I, 4),
    "raster_budget": (I, 1024), "raster_tile_chunk": (I, 16), "raster_impl": (S, ""),
    # ReferenceCompatConfig (:151-221): accepted so that a reference opts.log
    # parses; the port reads none of them
    "tet_grid_size": (I, 80), "freeze_warp": (B, False), "test_in_train": (B, False),
    "recon_keep_coarse": (B, False), "gen3d_optim_all": (B, False), "top_alpha": (F, 1.0),
    "gs": (F, 50.0), "gen3d_guidance": (S, "mvd"), "recon_no_coarsetofine": (B, False),
    "gen3d_wt": (F, 0.0), "gen3d_res": (I, 64), "gen3d_dist": (F, 1.0),
    "gen3d_freq": (F, 2.0), "gen3d_start_iters": (I, 0), "gen3d_dirprompt": (B, False),
    "render_uncert": (B, False), "gen3d_frameid": (I, -1), "seed": (I, -1),
    "gen3d_random_bkgd": (B, False), "prompt": (S, "A_photo_of_a_cat"),
    "reset_rgb_mlp": (B, False), "gen3d_sds_t_max": (F, 0.98), "rgb_only": (B, False),
    "geo_only": (B, False), "gen3d_regloss": (B, False), "gen3d_jacobloss": (B, False),
    "gen3d_cycloss": (B, False), "gen3d_sds_normal": (B, False), "lock_frameid": (I, -1),
    "lab4d_init_mesh": (S, ""), "freeze_bone_len": (B, False), "debug_cuda": (B, False),
    "use_gs_optimizer": (B, False), "not_load_warping": (B, False),
    "two_branch": (B, False), "dgs_k": (I, 4), "neus_branch_reso": (I, 64),
    "optim_warp_neus_iters": (I, 12000), "start_mutual_iters": (I, 999999),
    "mutual_depth_wt": (F, 1.0), "mutual_normal_wt": (F, 1.0), "mutual_mask_wt": (F, 1.0),
    "depth_guide_sample": (B, False), "novel_neus_interv": (I, -1),
    "vis2d_dilate": (B, False), "ip": (S, "127.0.0.1"), "port": (I, 6322),
    "debug_from": (I, -1), "detect_anomaly": (B, False),
    "test_iterations": (L, [7000, 30000]), "save_iterations": (L, [7000, 30000]),
    "quiet": (B, False), "checkpoint_iterations": (L, [30000]),
    "start_checkpoint": (S, ""), "source_path": (S, ""), "model_path": (S, ""),
    "images": (S, "images"), "resolution": (I, -1), "data_device": (S, "cuda"),
    "eval": (B, False), "debug": (B, False), "random_background": (B, False),
    "resolution_scale": (F, 2.0),
}

# the render / export / reanimate CLIs' own flags (`render.py:20-30`,
# `export.py:21-26`, `reanimate.py:19`)
RENDER_FLAGS = {
    "inst_id": (I, 0), "motion_id": (I, 1), "render_res": (I, 128), "viewpoint": (S, "ref"),
    "freeze_id": (I, -1), "num_frames": (I, -1), "rot_dist": (F, 2.0), "nowarp": (B, False),
    "logdir": (S, ""),
}
EXPORT_FLAGS = {
    "inst_id": (I, 0), "grid_size": (I, 128), "export_mesh_seq": (B, True),
    "export_mesh_stride": (I, 1),
}
REANIMATE_FLAGS = {**RENDER_FLAGS, "motion_path": (S, "")}
# the static 2DGS CLI's (`gs_static.py:21-26`) and the metrics CLI's
# (`metrics.py:18-19`) own flags
GS_STATIC_FLAGS = {
    "source_path_": (S, ""), "model_path_": (S, "out_gs"), "extract_mesh": (B, True),
    "downscale": (I, 1), "gui_ip": (S, ""), "gui_port": (I, 6323),
}
METRICS_FLAGS = {"pred_dir": (S, ""), "gt_dir": (S, "")}

# the port's entry-point flag, never written to opts.log: the device the
# entry point runs on (the card unless the CPU is asked for)
ENTRY_FLAGS = {"device": (S, "cuda")}

# absl's own flags (absl.app, absl.logging), written into every opts.log by
# the JAX save_config(); ignored here
ABSL_FLAGS = {
    **{n: (B, False) for n in (
        "help", "helpfull", "helpshort", "helpxml", "only_check_args", "pdb",
        "pdb_post_mortem", "run_with_pdb", "run_with_profiling",
        "use_cprofile_for_profiling", "alsologtostderr", "logtostderr",
        "showprefixforinfo")},
    **{n: (S, "") for n in (
        "log_dir", "logger_levels", "stderrthreshold", "verbosity", "v", "profile_file")},
}

_TRUE, _FALSE = ("true", "t", "1"), ("false", "f", "0")


def _convert(name: str, kind: str, value: str):
    if kind == F:
        return float(value)
    if kind == I:
        return int(value)
    if kind == L:
        return [s.strip() for s in value.split(",")] if value else []
    if kind == B:
        if value.lower() in _TRUE:
            return True
        if value.lower() in _FALSE:
            return False
        raise ValueError(f"--{name}: not a boolean: {value!r}")
    return value


def _expand_flagfiles(argv: Iterable[str], stack: Tuple[str, ...] = ()) -> List[str]:
    """argv with every ``--flagfile=PATH`` replaced in place by the flag
    lines of that file (absl: blank lines and lines starting with ``#`` or
    ``//`` skipped; a file that includes itself again is skipped)."""
    out: List[str] = []
    argv = list(argv)
    i = 0
    while i < len(argv):
        arg = argv[i]
        i += 1
        if arg.lstrip("-") == "flagfile" and arg.startswith("-"):
            if i >= len(argv):
                raise ValueError("--flagfile needs a value")
            path, i = argv[i], i + 1
        elif arg.startswith(("--flagfile=", "-flagfile=")):
            path = arg.split("=", 1)[1]
        else:
            out.append(arg)
            continue
        path = os.path.expanduser(path)
        if not path or path in stack:
            continue
        with open(path) as f:
            lines = [ln.strip() for ln in f
                     if not ln.isspace() and not ln.startswith(("#", "//"))]
        out.extend(_expand_flagfiles(lines, stack + (path,)))
    return out


def parse_flags(argv: Iterable[str],
                extra: Optional[Mapping[str, Tuple[str, object]]] = None) -> Dict:
    """absl-style ``argv`` (without the program name) -> dict of every flag
    of TRAIN_FLAGS, ENTRY_FLAGS and ``extra`` (an entry point's own table),
    defaults first, then the arguments in order. Raises ValueError for an
    unknown flag (absl's own are ignored), a malformed value or a
    positional argument."""
    table = {**TRAIN_FLAGS, **(extra or {}), **ENTRY_FLAGS}
    opts = {k: (list(d) if isinstance(d, list) else d) for k, (_, d) in table.items()}
    args = _expand_flagfiles(argv)
    i = 0
    while i < len(args):
        arg = args[i]
        i += 1
        if arg == "--":
            if i < len(args):
                raise ValueError(f"positional arguments are not accepted: {args[i:]}")
            break
        if not arg.startswith("-") or arg == "-":
            raise ValueError(f"positional arguments are not accepted: {arg!r}")
        name, eq, value = arg.lstrip("-").partition("=")
        negated = False
        if name not in table and name not in ABSL_FLAGS and name.startswith("no"):
            negated, name = True, name[2:]
        known = table.get(name) or ABSL_FLAGS.get(name)
        if known is None or (negated and known[0] != B):
            raise ValueError(f"unknown flag {arg!r}")
        kind = known[0]
        if kind == B:
            if negated and eq:
                raise ValueError(f"{arg!r}: --no{name} takes no value")
            val = (not negated) if not eq else _convert(name, kind, value)
        else:
            if not eq:
                if i >= len(args):
                    raise ValueError(f"--{name} needs a value")
                value, i = args[i], i + 1
            val = _convert(name, kind, value)
        if name in table:
            opts[name] = val
    return opts


def _serialize(kind: str, value) -> str:
    if kind == L:
        return ",".join(str(v) for v in value)
    return str(value)


def save_config(opts: Mapping) -> str:
    """Write the training flags of ``opts`` to
    ``<logroot>/<seqname>-<logname>/opts.log`` (replacing it), one
    ``--name=value`` line each (booleans as ``--name`` / ``--noname``), in
    the format absl's flagfile reader takes. Returns the path."""
    save_dir = os.path.join(opts["logroot"], "%s-%s" % (opts["seqname"], opts["logname"]))
    os.makedirs(save_dir, exist_ok=True)
    lines = []
    for name, (kind, _) in TRAIN_FLAGS.items():
        value = opts[name]
        if kind == B:
            lines.append(f"--{name}" if value else f"--no{name}")
        else:
            lines.append(f"--{name}={_serialize(kind, value)}")
    path = os.path.join(save_dir, "opts.log")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
