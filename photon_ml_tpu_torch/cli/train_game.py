"""GAME training from the command line (counterpart of ``photon_ml_tpu/cli/train_game.py``).

Read the training and validation Avro → feature shards, index maps and
entity vocabularies → build the coordinate datasets once → fit every grid
point on the GPU → select the best by the first validation evaluator →
write the best model (and, with ``--output-all-models``, every model) in
the reference's directory layout, with the index maps under
``feature-indexes/``. The directory loads in either package.

    python -m photon_ml_tpu_torch train_game --training-data train.avro \\
        --output-dir out --feature-shards 'global=g|intercept' \\
        --coordinates 'global=fixed,shard=global,reg=L2' \\
        --update-sequence global

It runs on the card unless ``--device cpu`` asks for the CPU. Outputs are
written by a background saver (:class:`~photon_ml_tpu_torch.io.pipeline.
BackgroundSaver`, on the chief only): the feature indexes and the data
manifest as soon as they exist, each model as soon as its configuration
ends, and the stage "Save models" is the join of what is left. Every GAME
model directory is staged and published by a rename, with the
``io.model_save`` fault site in the crash window, so a kill mid-save
never leaves a partial ``best/``; under ``--output-all-models`` ``best/``
is a hardlinked alias of the winner's ``all/config-i`` whose metadata
names it in ``aliasOf``. The validation data is read on a background
thread while training starts, and joined at its first use ("Read
validation data" records the join). The run root holds the
``data-manifest.json`` of the training data (``continuous/delta.py``), and
the models' metadata its lineage (``parentModel``, ``trainedAt``,
``dataManifest``), so ``refresh_game`` can warm-start from the run.
``--model-input-dir`` warm-starts from a saved run (its feature indexes
are reused) and ``--locked-coordinates`` keeps some of its coordinates
untrained; ``--checkpoint``/``--resume`` save and restore coordinate-
boundary state under ``<output-dir>/checkpoints``; ``--on-divergence``
sets the divergence guard's policy. ``--tuning RANDOM|BAYESIAN`` replaces
the grid with ``--tuning-iterations`` fits at points a random or a
Gaussian-process search picks in ``--tuning-range`` (every coordinate's
lambda), the coordinate datasets built once for all of them. The run root
also holds ``quality-baseline.json``: the best model's score profile on the
validation data (the training data without one), which serving's canary
and drift monitor read.

``--multihost`` runs one process per card
(:mod:`photon_ml_tpu_torch.game.multiprocess`, the job from the
``PHOTON_*`` environment): each process reads its share of the training
files, feature indexes and entity vocabularies are agreed across
processes, rows are shuffled so each process owns whole entities, the
fixed effect is one distributed solve (kernel 1 on each rank's rows, one
``all_reduce`` a evaluation) and the random effects solve on each
process's own card (kernel 2) with no collective; process 0 writes the
outputs, the others log under ``workers/proc-N``, and ``--checkpoint``
writes per-process sweep states under ``checkpoints-mp``. ``--supervise
N`` runs N such processes under the fleet supervisor
(:mod:`photon_ml_tpu_torch.resilience.supervisor`), which restarts them
from the checkpoint on a crash or a stale heartbeat.

``--mesh data=4,entity=2`` drives several slots from one process
(:mod:`photon_ml_tpu_torch.parallel.mesh`): the fixed effects' rows in
blocks over ``data`` (kernel 1 a block an evaluation, the partials summed
on the first slot), the random effects' bucket lanes over ``entity``
(kernel 2 a slot's slice). With ``--device cuda`` the slots are
``cuda:0…N-1`` and a mesh wider than the visible cards is refused; with
``--device cpu`` every slot is the CPU. It is refused beside a
multi-process ``--multihost``.

``--telemetry-dir`` writes the run's span tree (``trace.jsonl``: the
``train_game`` root, the stages, ``cd.sweep`` / ``cd.step`` /
``cd.validate``, reads and saves) and ``metrics.prom``;
``--telemetry-poll-s`` samples host and device memory and re-snapshots
``metrics.prom`` at that period; ``--metrics-port`` serves ``GET
/metrics`` from the chief (the fleet fold at each sweep under
``--multihost``). ``--profile`` writes a ``torch.profiler`` Chrome trace of
the training stage under ``<output-dir>/profile``; ``--debug-nans`` checks
every evaluation of the kernel dispatch for NaN/Inf
(:mod:`photon_ml_tpu_torch.ops.objective`).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
from typing import Optional, Sequence

import torch

from photon_ml_tpu_torch.cli.config import (
    DriverTelemetry,
    add_resilience_flags,
    add_telemetry_flags,
    install_resilience,
    install_telemetry,
    parse_coordinate_config,
    parse_feature_shard_config,
    parse_grid,
    resilience_from_args,
    telemetry_from_args,
)
from photon_ml_tpu_torch.data_validation import validate_game_data
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation import parse_evaluators
from photon_ml_tpu_torch.game.estimator import (
    FactoredRandomEffectCoordinateConfig,
    FixedEffectCoordinateConfig,
    GameEstimator,
    GameOptimizationConfiguration,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.io.data_reader import AvroDataReader, parse_input_columns
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.io.model_io import (
    find_feature_index_dir,
    load_warm_start_model,
    resolve_game_model_dir,
)
from photon_ml_tpu_torch.io.pipeline import (
    BackgroundSaver,
    publish_model_alias,
    read_in_background,
)
from photon_ml_tpu_torch.logging_util import RunLogger, profiled, timed
from photon_ml_tpu_torch.ops import objective as _objective
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.quality.baseline import (
    BASELINE_NAME,
    baseline_from_game,
    save_baseline,
)
from photon_ml_tpu_torch.resilience.supervisor import (
    add_supervision_flags,
    supervise_from_args,
    write_result_file,
)
from photon_ml_tpu_torch.types import DataValidationType, TaskType

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch train_game",
        description="Train a GAME mixed-effect model (GPU)")
    p.add_argument("--training-data", required=True)
    p.add_argument("--validation-data")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.value for t in TaskType])
    p.add_argument("--feature-shards", required=True,
                   help="comma-separated shard specs, e.g. "
                        "'global=fixed|intercept,user=user+item|noIntercept'")
    p.add_argument("--coordinates", required=True, nargs="+",
                   help="coordinate specs, e.g. "
                        "'global=fixed,shard=global,reg=L2' "
                        "'perUser=random,entity=userId,shard=user,reg=L2'")
    p.add_argument("--update-sequence", required=True,
                   help="comma-separated coordinate ids")
    p.add_argument("--cd-iterations", type=int, default=1)
    p.add_argument("--grid", nargs="*", default=[],
                   help="per-coordinate lambda lists 'coordId=0.1;1;10'")
    p.add_argument("--tuning", choices=["NONE", "RANDOM", "BAYESIAN"],
                   default="NONE")
    p.add_argument("--tuning-iterations", type=int, default=10)
    p.add_argument("--tuning-range", default="1e-4:1e4",
                   help="lambda search range 'low:high' for tuning")
    p.add_argument("--evaluators", default="AUC",
                   help="comma-separated; first drives model selection")
    p.add_argument("--output-all-models", action="store_true")
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=[v.value for v in DataValidationType])
    p.add_argument("--design-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the dense designs (fixed-effect "
                        "and random-effect bucket tensors) on the device; "
                        "labels, weights and coefficients stay float32 and "
                        "margins accumulate in float32")
    p.add_argument("--model-sparsity-threshold", type=float, default=0.0,
                   help="drop |coefficient| <= threshold from written "
                        "models")
    p.add_argument("--input-columns", default="",
                   help="remap record fields, e.g. 'response=label,"
                        "weight=w'")
    p.add_argument("--model-input-dir",
                   help="warm-start from a previous train_game or "
                        "refresh_game output dir (the partial-retrain "
                        "path); its feature indexes are reused so "
                        "coefficients line up")
    p.add_argument("--locked-coordinates", default="",
                   help="comma-separated coordinate ids to freeze (kept "
                        "from --model-input-dir, never retrained)")
    p.add_argument("--checkpoint", action="store_true",
                   help="write coordinate-boundary checkpoints under "
                        "<output-dir>/checkpoints (single-config grids)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "<output-dir>/checkpoints")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on NaN: every objective evaluation and "
                        "Hessian-vector product of the kernel dispatch is "
                        "checked, raising FloatingPointError naming the "
                        "kernel and shape")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace (CUDA activity "
                        "included on the card) of the training stage to "
                        "<output-dir>/profile/trace.json (view in "
                        "chrome://tracing or Perfetto)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solves run (default: the GPU; there is "
                        "no fall-back to the CPU)")
    p.add_argument("--multihost", action="store_true",
                   help="join the multi-process job of the PHOTON_* "
                        "environment (one process per card): per-process "
                        "file reads, entity-partitioned random effects, a "
                        "distributed fixed effect; process 0 writes")
    p.add_argument("--mesh", default="",
                   help="device mesh axes, e.g. 'data=4,entity=2': shards "
                        "fixed-effect samples over 'data' (psum'd compiled "
                        "optimizer) and random-effect entity lanes over "
                        "'entity'. Default: single device")
    add_supervision_flags(p)
    add_resilience_flags(p)
    add_telemetry_flags(p)
    return p


def preset_index_maps(model_dir: str, shard_configs) -> dict[str, IndexMap]:
    """The feature index maps of the run that wrote ``model_dir``, one per
    configured shard: a warm start lives in its parent's feature space."""
    index_dir = find_feature_index_dir(model_dir)
    return {cfg.shard_id: IndexMap.load(
        os.path.join(index_dir, f"{cfg.shard_id}.json"))
        for cfg in shard_configs}


def _tune(args, est: GameEstimator, data, validation, evaluators,
          update_sequence, initial_models, locked, guard,
          mp_fit=None, on_result=None) -> list:
    """``--tuning RANDOM|BAYESIAN``: ``--tuning-iterations`` fits at the
    points the search picks (every trained coordinate's lambda in
    ``--tuning-range``, log-scaled), the coordinate datasets built once and
    their device images released after the search. With ``mp_fit`` (the
    multi-process path) every process runs the same seeded search, each
    point one collective fit whose metric every process computes alike.
    ``on_result(index, result)`` fires as each fit ends."""
    from photon_ml_tpu_torch.hyperparameter.search import (
        GaussianProcessSearch,
        ParamRange,
        RandomSearch,
    )

    low, high = (float(x) for x in args.tuning_range.split(":"))
    # a locked coordinate never trains: its lambda is a dead axis
    space = {cid: ParamRange(low, high) for cid in update_sequence
             if cid not in locked}
    datasets = {} if mp_fit else est.prepare(data, locked=locked)
    results = []

    def evaluate(config: dict) -> float:
        if mp_fit:
            r = mp_fit(GameOptimizationConfiguration(config))
        else:
            r = est.fit(data, [GameOptimizationConfiguration(config)],
                        validation=validation, datasets=datasets,
                        initial_models=initial_models, locked=locked,
                        guard=guard)[0]
        results.append(r)
        if on_result is not None:
            on_result(len(results) - 1, r)
        return r.evaluation.primary[1]

    if args.tuning == "BAYESIAN":
        GaussianProcessSearch(space, maximize=evaluators[0].maximize).find(
            evaluate, args.tuning_iterations)
    else:
        RandomSearch(space).find(evaluate, args.tuning_iterations)
    for ds in datasets.values():
        if hasattr(ds, "clear_device_cache"):
            ds.clear_device_cache()
    data.clear_device_cache()
    return results


def parse_mesh(spec: str, device="cuda"):
    """'data=4,entity=2' → :class:`~photon_ml_tpu_torch.parallel.mesh.Mesh`
    (None when empty): on ``cuda`` over the visible cards, refused when
    there are fewer; on ``cpu`` every slot the CPU."""
    if not spec:
        return None
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if name in axes:
            raise SystemExit(f"duplicate mesh axis {name!r}")
        try:
            axes[name] = int(size)
        except ValueError:
            raise SystemExit(f"bad --mesh entry {part!r}; want axis=<int>")
        if name not in ("data", "entity", "feature"):
            raise SystemExit(
                f"unknown mesh axis {name!r}; choose from data/entity/feature")
        if axes[name] < 1:
            raise SystemExit(f"mesh axis {name!r} must be >= 1, got {axes[name]}")
    devices = None
    if torch.device(device).type == "cpu":
        n = 1
        for size in axes.values():
            n *= size
        devices = [torch.device("cpu")] * n
    try:
        return make_mesh(axes, devices=devices)
    except ValueError as e:  # more slots than visible cards
        raise SystemExit(f"--mesh {spec!r}: {e}")


def _run_supervised(raw_argv: Sequence[str], args) -> dict:
    """``--supervise N``: this command relaunched as an N-process
    supervised fleet; the workers get ``--checkpoint --resume`` (a restart
    resumes from the latest agreed checkpoint) and, at N > 1,
    ``--multihost``. The supervising process never trains."""
    if args.tuning != "NONE" or len(parse_grid(args.grid)) != 1:
        raise SystemExit(
            "--supervise needs a single-config grid and no --tuning: "
            "restart-from-checkpoint resumes ONE training (the same "
            "constraint as --checkpoint/--resume)")
    worker_flags = ["--checkpoint", "--resume"]
    if args.supervise > 1:
        worker_flags.append("--multihost")
    # the supervisor's own telemetry (its spans and the photon_supervisor_*
    # bridge metrics) lands under supervisor/telemetry; the workers own the
    # run's telemetry directories and the metrics port
    telemetry = install_telemetry(dataclasses.replace(
        telemetry_from_args(args,
                            subdir=os.path.join("supervisor", "telemetry")),
        metrics_port=0))
    try:
        return supervise_from_args("train_game", raw_argv, args,
                                   worker_flags=worker_flags)
    finally:
        telemetry.close()


def _mp_fit_fn(args, data, task, coordinate_configs, update_sequence,
               initial_models, locked, validation, guard, device):
    """One collective multi-process fit of a configuration, evaluated
    and wrapped as a :class:`GameResult` (grid and tuning share it)."""
    from photon_ml_tpu_torch.evaluation import evaluate_all
    from photon_ml_tpu_torch.game.estimator import GameResult
    from photon_ml_tpu_torch.game.multiprocess import train_game_multiprocess

    mp_ckpt = (os.path.join(args.output_dir, "checkpoints-mp")
               if args.checkpoint or args.resume else None)

    def fit(config: GameOptimizationConfiguration) -> GameResult:
        mp = train_game_multiprocess(
            data, task, coordinate_configs, update_sequence,
            config.regularization_weights,
            n_cd_iterations=args.cd_iterations, checkpoint_dir=mp_ckpt,
            resume=args.resume, initial_models=initial_models,
            locked=locked, validation=validation, guard=guard,
            device=device)
        evaluation = None
        if validation is not None:
            vdata, evs = validation
            evaluation = evaluate_all(
                evs, mp.model.score(vdata), vdata.labels,
                weights=vdata.weights, id_tags=vdata.id_columns)
        return GameResult(model=mp.model, configuration=config,
                          evaluation=evaluation,
                          validation_history=list(mp.validation_history))

    return fit


def _joined_at_first_use(future, evaluators, run_logger):
    """The validation argument of a fit whose data is read in the
    background: a callable joining ``future`` at its first call, under the
    "Read validation data" stage, and returning ``(data, evaluators)``
    from then on."""
    cell = []

    def validation():
        if not cell:
            with timed("Read validation data", run_logger):
                vdata, _, _ = future.result()
            cell.append((vdata, evaluators))
        return cell[0]

    return validation


def run(argv: Optional[Sequence[str]] = None) -> dict:
    from photon_ml_tpu_torch.continuous import delta as delta_mod
    from photon_ml_tpu_torch.io.checkpoint import CheckpointManager

    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(raw_argv)
    if args.supervise:
        return _run_supervised(raw_argv, args)
    task = TaskType(args.task)
    # the retry policy goes in before anything that may retry (the job's
    # formation is the first)
    guard = install_resilience(resilience_from_args(args))
    # fail before the reads when no card is present
    device = resolve_device(args.device)
    multiproc = False
    if args.multihost:
        multiproc = multihost.initialize(device=args.device)
        device = multihost.local_device()
    if multiproc and args.mesh:
        raise SystemExit(
            "multi-process --multihost training does not take --mesh: the "
            "ranks' data layout is built automatically, the entity axis is "
            "subsumed by the entity->process partition, and feature "
            "sharding across processes has no photon-scale workload")
    # a bad mesh spec or too few cards fails before the reads
    mesh = parse_mesh(args.mesh, device)
    chief = multihost.is_chief()
    # a non-chief process logs under its own directory: N processes
    # appending to one photon.log / metrics.jsonl would interleave
    worker_dir = os.path.join("workers", f"proc-{multihost.process_index()}")
    run_logger = RunLogger(args.output_dir if chief else os.path.join(
        args.output_dir, worker_dir))
    debug_nans = _objective.debug_nans()
    _objective.set_debug_nans(debug_nans or args.debug_nans)
    # telemetry before the first event; a non-chief process traces under
    # its own workers/ directory
    telemetry = DriverTelemetry(
        args, "train_game", subdir=None if chief else worker_dir,
        started=dict(task=task.value, output_dir=args.output_dir))
    profile_dir = (os.path.join(args.output_dir, "profile")
                   if args.profile else None)
    # the chief's writer service: indexes, manifest, models and baseline
    # are written on background threads and joined in "Save models"
    saver = BackgroundSaver() if chief else None
    try:
        shard_configs = tuple(parse_feature_shard_config(s)
                              for s in args.feature_shards.split(","))
        coordinate_configs = dict(parse_coordinate_config(s)
                                  for s in args.coordinates)
        if args.design_dtype != "float32":
            if any(isinstance(c, FactoredRandomEffectCoordinateConfig)
                   for c in coordinate_configs.values()):
                # factored coordinates solve in the projected space on f32
                # designs: a bf16 request cannot apply to them
                raise SystemExit(
                    "--design-dtype bfloat16 does not apply to factored "
                    "random-effect coordinates (their projected designs "
                    "are float32); drop the flag or the factored "
                    "coordinate")
            coordinate_configs = {
                cid: (dataclasses.replace(c, design_dtype=args.design_dtype)
                      if isinstance(c, (FixedEffectCoordinateConfig,
                                        RandomEffectCoordinateConfig))
                      else c)
                for cid, c in coordinate_configs.items()}
        update_sequence = [c for c in args.update_sequence.split(",") if c]
        locked = [c for c in args.locked_coordinates.split(",") if c]
        if locked and not args.model_input_dir:
            raise SystemExit("--locked-coordinates needs --model-input-dir")
        re_types = {
            c.dataset.random_effect_type
            for c in coordinate_configs.values()
            if isinstance(c, (RandomEffectCoordinateConfig,
                              FactoredRandomEffectCoordinateConfig))}
        model_dir = None
        if args.model_input_dir:
            model_dir = resolve_game_model_dir(args.model_input_dir)
            # a locked coordinate may have no config entry, but its
            # entity-id column must still be read so the loaded model's
            # entity keys resolve
            with open(os.path.join(model_dir, "model-metadata.json")) as f:
                for info in json.load(f)["coordinates"].values():
                    if info["type"] == "random-effect":
                        re_types.add(info["randomEffectType"])
        re_types = sorted(re_types)
        evaluators = parse_evaluators(
            [e for e in args.evaluators.split(",") if e])
        # entity columns, then the grouped evaluators' id tags
        id_columns = tuple(dict.fromkeys(
            re_types + [e.id_tag for e in evaluators if e.id_tag]))
        # the estimator checks its configuration before the reads
        est = GameEstimator(task=task, coordinate_configs=coordinate_configs,
                            update_sequence=update_sequence,
                            n_cd_iterations=args.cd_iterations, device=device,
                            mesh=mesh)
        configurations = None
        if args.tuning == "NONE":
            grid = parse_grid(args.grid)
            unknown = {cid for g in grid for cid in g} - set(update_sequence)
            if unknown:
                raise SystemExit(
                    f"--grid names unknown coordinates {sorted(unknown)}; "
                    f"update sequence is {update_sequence}")
            configurations = [GameOptimizationConfiguration(g) for g in grid]
        else:
            if not args.validation_data:
                raise SystemExit("--tuning needs --validation-data")
            if args.checkpoint or args.resume:
                raise SystemExit("--checkpoint/--resume don't combine with "
                                 "--tuning")
        checkpoint = None
        if args.checkpoint or args.resume:
            if len(configurations) != 1:
                raise SystemExit(
                    "--checkpoint/--resume need a single-config grid (got "
                    f"{len(configurations)} configs)")
            if not multiproc:
                # the multi-process path keeps per-process sweep states
                checkpoint = CheckpointManager(
                    os.path.join(args.output_dir, "checkpoints"))

        reader = AvroDataReader(
            shard_configs=shard_configs,
            index_maps=(preset_index_maps(model_dir, shard_configs)
                        if model_dir else None),
            input_columns=parse_input_columns(args.input_columns))
        with timed("Read training data", run_logger):
            if multiproc:
                # this process's share of the files, then one feature
                # index and entity vocabulary agreed by every process
                from photon_ml_tpu_torch.game.multiprocess import (
                    process_file_share,
                    reconcile_global_ids,
                )

                data, index_maps, vocabs = reader.read(
                    process_file_share(reader, args.training_data),
                    id_columns=id_columns)
                data, index_maps, vocabs = reconcile_global_ids(
                    data, index_maps, vocabs, id_columns)
            else:
                data, index_maps, vocabs = reader.read(
                    args.training_data, id_columns=id_columns)
        if chief:
            # the index maps are final from here on
            for shard_id, imap in index_maps.items():
                saver.submit_file_write(
                    imap.save, os.path.join(args.output_dir,
                                            "feature-indexes",
                                            f"{shard_id}.json"),
                    label="io.save.index", shard=shard_id)

        initial_models = None
        parent_lineage = None
        if model_dir:
            with timed("Load initial model", run_logger):
                initial, parent_lineage = load_warm_start_model(
                    model_dir, index_maps, vocabs, device=device)
                initial_models = dict(initial.coordinates)
            missing = set(locked) - set(initial_models)
            if missing:
                raise SystemExit(
                    f"locked coordinates {sorted(missing)} not present in "
                    f"the input model")

        # the data manifest (fingerprints of each entity's training rows,
        # from the host columns) and the lineage every saved model records;
        # a multi-process share sees part of the rows, so its manifest
        # would flag every entity read elsewhere as changed: none there
        manifest_digest = None
        if not multiproc:
            re_coords = {
                cid: (c.dataset.random_effect_type,
                      c.dataset.feature_shard_id)
                for cid, c in coordinate_configs.items()
                if isinstance(c, RandomEffectCoordinateConfig)}
            with timed("Build data manifest", run_logger):
                manifest = delta_mod.build_manifest(data, re_coords, vocabs)
            manifest_digest = delta_mod.manifest_digest(manifest)
            if chief:
                saver.submit_file_write(
                    lambda path, m=manifest: delta_mod.save_manifest(path, m),
                    os.path.join(args.output_dir, delta_mod.MANIFEST_NAME),
                    label="io.save.manifest")
        lineage = {
            "parentModel": parent_lineage,
            "trainedAt": datetime.datetime.now(
                datetime.timezone.utc).isoformat(),
            "dataManifest": manifest_digest,
        }
        with timed("Validate data", run_logger):
            validate_game_data(data, task,
                               DataValidationType(args.data_validation))

        validation = None
        if args.validation_data:
            reader_v = AvroDataReader(shard_configs=shard_configs,
                                      index_maps=index_maps,
                                      input_columns=reader.input_columns)
            if multiproc:
                # every process holds the data before the collective
                # training starts
                with timed("Read validation data", run_logger):
                    vdata, _, _ = reader_v.read(
                        args.validation_data, id_columns=id_columns,
                        entity_vocabs=vocabs)
                validation = (vdata, evaluators)
            else:
                # read in the background while the first sweep trains;
                # joined at its first use, where "Read validation data"
                # records the join (the part of the read left visible)
                validation = _joined_at_first_use(
                    read_in_background(
                        reader_v.read, args.validation_data,
                        id_columns=id_columns, entity_vocabs=vocabs,
                        label="io.read.validation"),
                    evaluators, run_logger)

        # each model is submitted to the saver the moment its configuration
        # ends: under --output-all-models every one to all/config-i (best/
        # is published later as an alias of the winner), and a
        # single-configuration grid's one result straight to best/
        single_config = (configurations is not None and not multiproc
                         and len(configurations) == 1)

        def note_result(i, r):
            if saver is None:
                return
            if args.output_all_models:
                saver.submit_game_save(
                    os.path.join(args.output_dir, "all", f"config-{i}"),
                    r.model, index_maps, vocabs,
                    sparsity_threshold=args.model_sparsity_threshold,
                    lineage=lineage)
            elif single_config:
                saver.submit_game_save(
                    os.path.join(args.output_dir, "best"), r.model,
                    index_maps, vocabs,
                    sparsity_threshold=args.model_sparsity_threshold,
                    lineage=lineage)

        mp_fit = None
        if multiproc:
            mp_fit = _mp_fit_fn(args, data, task, coordinate_configs,
                                update_sequence, initial_models, locked,
                                validation, guard, device)
        stage = ("Train (grid)" if configurations is not None
                 else f"Train ({args.tuning} tuning)")
        if multiproc:
            stage = stage[:-1] + ", multi-process)"
        with timed(stage, run_logger), profiled(profile_dir):
            if configurations is not None and multiproc:
                # grid points in turn, each one collective fit
                results = []
                for c in configurations:
                    results.append(mp_fit(c))
                    note_result(len(results) - 1, results[-1])
            elif configurations is not None:
                results = est.fit(
                    data, configurations, validation=validation,
                    initial_models=initial_models, locked=locked,
                    checkpoint=checkpoint, resume=args.resume, guard=guard,
                    on_result=note_result)
            else:
                results = _tune(args, est, data, validation, evaluators,
                                update_sequence, initial_models, locked,
                                guard, mp_fit=mp_fit, on_result=note_result)
            # the last solves finish inside this stage, not in "Save models"
            # (one element of the last table still on the device is read;
            # the synchronize covers a mesh's other slots)
            results[-1].model.device_wait()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if guard.failures:
            run_logger.metric(
                stage="divergence", failures=dict(guard.failures),
                frozen=sorted(guard.frozen),
                regularization=[r.regularization_weights for r in results])

        best = GameEstimator.select_best(results)
        if best.evaluation is not None:
            run_logger.metric(stage="best", **best.evaluation.as_dict(),
                              config=dict(best.configuration.regularization_weights))

        best_dir = os.path.join(args.output_dir, "best")
        result = {
            "best_config": dict(best.configuration.regularization_weights),
            "best_evaluation": (best.evaluation.as_dict()
                                if best.evaluation else None),
            "n_configurations": len(results),
            "output_dir": args.output_dir,
        }
        if not chief:
            # returns once the chief's outputs are complete
            multihost.barrier()
            return result
        # the winner's quality baseline at the run root: its score
        # distribution on the validation data (the training data when the
        # run has none), which serving compares live traffic with; computed
        # and written on the writer pool
        bdata = (data if validation is None else
                 (validation() if callable(validation) else validation)[0])
        saver.submit_file_write(
            lambda path: save_baseline(path, baseline_from_game(
                best.model, bdata, task=task, lineage=lineage)),
            os.path.join(args.output_dir, BASELINE_NAME),
            label="quality.baseline")
        if not (args.output_all_models or single_config):
            # the winner of several configurations is known only now
            saver.submit_game_save(
                best_dir, best.model, index_maps, vocabs,
                sparsity_threshold=args.model_sparsity_threshold,
                lineage=lineage)
        # the join of what the writers have not finished under training
        # and selection, and under --output-all-models the alias publish
        with timed("Save models", run_logger):
            saver.join()
            if args.output_all_models:
                best_i = next(i for i, r in enumerate(results) if r is best)
                publish_model_alias(os.path.join(
                    args.output_dir, "all", f"config-{best_i}"), best_dir)
        multihost.barrier()
        # a supervised run hands its result to the supervisor
        write_result_file(result)
        return result
    finally:
        if saver is not None:
            # the happy path joined already; this waits out the writes a
            # failing run left in flight
            saver.close()
        telemetry.close()
        _objective.set_debug_nans(debug_nans)
        run_logger.close()


if __name__ == "__main__":
    run()
