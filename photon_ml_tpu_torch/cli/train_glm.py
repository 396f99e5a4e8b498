"""Single-GLM training from the command line (counterpart of
``photon_ml_tpu/cli/train_glm.py``, the reference's legacy GLM pipeline).

Read the training Avro → check the rows → when asked, summarize the
features and normalize → train one model per regularization weight
(sequentially with warm starts, or all lambdas as lanes of one batched
solve; L-BFGS, TRON, or OWL-QN where the regularization has an L1 part) →
score each on the validation data and select the best by the first
evaluator → write ``best/`` and ``all/lambda-*/`` (``model.avro`` and
``model.txt`` each) beside ``feature-index.json`` and, when asked,
``summary.avro``; with ``--training-diagnostics``, then the reference's
diagnosed stage: ``diagnostics/report.html`` with
``--diagnostic-bootstrap-replicates`` bootstrap solves (coefficient CIs in
the original feature space), Hosmer–Lemeshow on the validation data (the
training data without one; logistic only), feature importance and, with
validation data, the fitting curve. The directory loads in either package.

    python -m photon_ml_tpu_torch train_glm --training-data train.avro \\
        --validation-data valid.avro --output-dir out \\
        --regularization-weights '10;1;0.1' --evaluators AUC

A shard of at most :data:`DENSE_MAX_DIM` columns trains on a dense design
(kernels 1, 3 and 4 on the card); a wider one on a
:class:`~photon_ml_tpu_torch.ops.design.ChunkedSparseDesign` in f32. It runs
on the card unless ``--device cpu`` asks for the CPU. Reads run under the
retry policy of ``--max-retries`` and ``--retry-deadline-s``; a lambda
whose coefficients are not finite fails the run under ``--on-divergence
fail`` and is dropped from selection under ``rollback`` or ``freeze``.
Outputs are written by a background saver on the chief
(:class:`~photon_ml_tpu_torch.io.pipeline.BackgroundSaver`): the feature
index and every lambda's model as soon as the sweep ends, overlapping the
validation read and selection, then ``best/`` once validation picks it;
"Save models" is the join.

``--multihost`` runs one process per card (the job from the
``PHOTON_COORDINATOR_ADDRESS`` / ``PHOTON_NUM_PROCESSES`` /
``PHOTON_PROCESS_ID`` environment, :mod:`photon_ml_tpu_torch.parallel.
multihost`): each process reads its share of the training files, the
feature index is agreed across processes, feature statistics are
all-reduced, and the sequential sweep solves the distributed objective —
kernel 1 (and kernel 3 under TRON) on each rank's rows, one
``all_reduce`` a evaluation — in lockstep; process 0 writes the outputs,
the others log under ``workers/proc-N``. ``--supervise N`` runs N such
processes under the fleet supervisor
(:mod:`photon_ml_tpu_torch.resilience.supervisor`), restarting them on a
crash or a stale heartbeat (the sweep has no checkpoint: a restart
re-solves it, bit for bit).

``--telemetry-dir`` writes the run's span tree (``trace.jsonl``, rooted at
``train_glm``) and ``metrics.prom`` (each lambda's solve under
``glm.sweep_solve``); ``--telemetry-poll-s`` samples host and device
memory; ``--metrics-port`` serves ``GET /metrics`` from the chief (the
fleet fold at each lambda under ``--multihost``). ``--profile`` writes a
``torch.profiler`` Chrome trace of the "Train" stage under
``<output-dir>/profile``; ``--debug-nans`` checks every evaluation and
Hessian-vector product of the kernel dispatch for NaN/Inf.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.cli.config import (
    DriverTelemetry,
    add_resilience_flags,
    add_telemetry_flags,
    install_resilience,
    install_telemetry,
    resilience_from_args,
    telemetry_from_args,
)
from photon_ml_tpu_torch.data_validation import validate_game_data
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.diagnostics import (
    bootstrap_coefficients,
    expected_magnitude_importance,
    fitting_curve,
    hosmer_lemeshow,
    variance_importance,
    write_report,
)
from photon_ml_tpu_torch.evaluation import parse_evaluators
from photon_ml_tpu_torch.events import GLOBAL_BUS
from photon_ml_tpu_torch.game.data import (
    GameData,
    design_dtype_of,
    host_design_for_shard,
)
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
from photon_ml_tpu_torch.glm.training import (
    build_problem,
    train_glm_sweep,
    train_glm_sweep_batched,
    validate_and_select,
)
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.data_reader import (
    AvroDataReader,
    FeatureShardConfig,
    parse_input_columns,
)
from photon_ml_tpu_torch.io.model_io import (
    load_glm_model,
    save_glm_model,
    save_glm_model_text,
)
from photon_ml_tpu_torch.io.pipeline import BackgroundSaver
from photon_ml_tpu_torch.io.schemas import FEATURE_SUMMARIZATION_RESULT_AVRO
from photon_ml_tpu_torch.logging_util import (
    RunLogger,
    log_optimizer_trace,
    profiled,
    timed,
)
from photon_ml_tpu_torch.ops import objective as _objective
from photon_ml_tpu_torch.ops.design import ChunkedSparseDesign, DenseDesign
from photon_ml_tpu_torch.ops.normalization import (
    NoNormalization,
    build_normalization,
)
from photon_ml_tpu_torch.ops.objective import GLMData
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.resilience import DivergenceError
from photon_ml_tpu_torch.resilience.supervisor import (
    add_supervision_flags,
    supervise_from_args,
    write_result_file,
)
from photon_ml_tpu_torch.stat import FeatureDataStatistics
from photon_ml_tpu_torch.types import (
    INTERCEPT_KEY,
    DataValidationType,
    NormalizationType,
    OptimizerType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)

#: the widest shard trained on a dense design
DENSE_MAX_DIM = 4096

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch train_glm",
        description="Train a single GLM over a regularization sweep (GPU)")
    p.add_argument("--training-data", required=True)
    p.add_argument("--validation-data")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.value for t in TaskType])
    p.add_argument("--optimizer", default="LBFGS",
                   choices=[o.value for o in OptimizerType])
    p.add_argument("--regularization-type", default="L2",
                   choices=[r.value for r in RegularizationType])
    p.add_argument("--elastic-net-alpha", type=float, default=0.5)
    p.add_argument("--regularization-weights", default="1.0",
                   help="semicolon-separated, e.g. '10;1;0.1'")
    p.add_argument("--normalization", default="NONE",
                   choices=[n.value for n in NormalizationType])
    p.add_argument("--evaluators", default="",
                   help="comma-separated evaluator specs (first selects "
                        "the model)")
    p.add_argument("--max-iterations", type=int, default=80)
    p.add_argument("--tolerance", type=float, default=1e-6)
    p.add_argument("--no-intercept", action="store_true")
    p.add_argument("--variance-computation", default="NONE",
                   choices=["NONE", "SIMPLE", "FULL"])
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=[v.value for v in DataValidationType])
    p.add_argument("--summarization-output", action="store_true",
                   help="write per-feature summary stats avro")
    p.add_argument("--training-diagnostics", action="store_true",
                   help="write diagnostics/report.html (bootstrap CIs, "
                        "Hosmer-Lemeshow, feature importance, fitting "
                        "curve)")
    p.add_argument("--diagnostic-bootstrap-replicates", type=_positive_int,
                   default=16)
    p.add_argument("--input-columns", default="",
                   help="remap record fields, e.g. 'response=label'")
    p.add_argument("--warm-start", metavar="DIR",
                   help="seed the sweep's first solve from a previous "
                        "run's best model (DIR holds best/model.avro, or "
                        "is a model.avro's directory); coefficients join "
                        "by feature name. Sequential sweep mode only")
    p.add_argument("--design-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of a dense design on the device "
                        "(a sparse design keeps f32 values)")
    p.add_argument("--sweep-mode", default="sequential",
                   choices=["sequential", "batched"],
                   help="sequential: warm-started descending lambda sweep "
                        "(the reference's semantics); batched: one solve "
                        "with a lane per lambda, each from zero")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace (CUDA activity "
                        "included on the card) of the training stage to "
                        "<output-dir>/profile/trace.json (view in "
                        "chrome://tracing or Perfetto)")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on NaN: every objective evaluation and "
                        "Hessian-vector product of the kernel dispatch is "
                        "checked, raising FloatingPointError naming the "
                        "kernel and shape. Strict debugging mode: also "
                        "flags a line search's non-finite probe on an "
                        "overflowing trial step, which a normal run "
                        "backtracks from")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solves run (default: the GPU; there is "
                        "no fall-back to the CPU)")
    p.add_argument("--multihost", action="store_true",
                   help="join the multi-process job of the PHOTON_* "
                        "environment: each process reads its share of the "
                        "training files and solves on its own rows, and "
                        "only process 0 writes outputs")
    add_supervision_flags(p)
    add_resilience_flags(p)
    add_telemetry_flags(p)
    return p


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _to_glm_data(data: GameData, shard_id: str, dtype, device) -> GLMData:
    """The shard as a :class:`GLMData` on ``device``: dense in ``dtype`` up
    to :data:`DENSE_MAX_DIM` columns (densified on the device), else a
    chunked sparse design with f32 values."""
    shard = data.shards[shard_id]
    if shard.dim <= DENSE_MAX_DIM:
        design = DenseDesign(x=data.device_dense_shard(
            shard_id, design_dtype_of(dtype), device))
    else:
        design = ChunkedSparseDesign.from_coo(
            shard.rows(), shard.cols, shard.vals,
            n_rows=shard.n_samples, n_cols=shard.dim, device=device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return GLMData(design=design, labels=put(data.labels),
                   offsets=put(data.offsets), weights=put(data.weights))


def _run_diagnostics(args, task, best, glm_train, glm_val, shard, stats, imap,
                     config, normalization, reg_mask, run_logger) -> str:
    """The reference driver's DIAGNOSED stage (``--training-diagnostics``):
    bootstrap CIs, Hosmer-Lemeshow (logistic only), feature importance and
    the fitting curve, written as ``diagnostics/report.html``. The
    replicate and portion solves run where the training data lies, each
    lane with its own weight vector (kernel 1 per lane on a dense design).
    """
    problem = build_problem(task, config, normalization, reg_mask)
    lam = best.regularization_weight
    # the sweep's solution in transformed (normalized) space
    w_t = best.result.w
    # replicate solutions live in transformed space; report the CIs in the
    # original feature space, as the published coefficients are
    transform = (None if normalization.is_identity
                 else normalization.model_to_original)
    boot = bootstrap_coefficients(
        problem, glm_train, w_t, lam,
        n_replicates=args.diagnostic_bootstrap_replicates,
        transform=transform)

    hl = None
    if task == TaskType.LOGISTIC_REGRESSION:
        ev_data = glm_val if glm_val is not None else glm_train
        probs = best.model.predict_mean(ev_data.design, ev_data.offsets)
        hl = hosmer_lemeshow(probs, ev_data.labels, ev_data.weights)
        run_logger.metric(stage="diagnostics", hl_chi_square=hl.chi_square,
                          hl_p_value=hl.p_value)

    if stats is None:
        stats = FeatureDataStatistics.from_shard(shard)
    names = imap.names()
    coefs = best.model.coefficients.means
    importance = [variance_importance(coefs, stats, names=names),
                  expected_magnitude_importance(coefs, stats, names=names)]

    fitting = None
    if glm_val is not None:
        # every portion warm-starts from the trained solution
        fitting = fitting_curve(problem, glm_train, glm_val, w_t, lam)

    return write_report(
        os.path.join(args.output_dir, "diagnostics", "report.html"),
        model_summary={
            "task": task.value,
            "best lambda": lam,
            "optimizer": config.optimizer.value,
            "iterations": int(best.result.iterations),
            "converged": bool(best.result.converged),
        },
        bootstrap=boot, hosmer_lemeshow=hl, importance=importance,
        fitting=fitting, feature_names=names)


def run(argv: Optional[Sequence[str]] = None) -> dict:
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(raw_argv)
    if args.supervise:
        # the sweep has no checkpoint: a restarted fleet re-solves it. The
        # supervisor's own telemetry lands under supervisor/telemetry; the
        # workers own the run's telemetry and the metrics port
        import dataclasses

        telemetry = install_telemetry(dataclasses.replace(
            telemetry_from_args(
                args, subdir=os.path.join("supervisor", "telemetry")),
            metrics_port=0))
        try:
            return supervise_from_args(
                "train_glm", raw_argv, args,
                worker_flags=("--multihost",) if args.supervise > 1 else ())
        finally:
            telemetry.close()
    task = TaskType(args.task)
    if args.warm_start and args.sweep_mode == "batched":
        raise SystemExit(
            "--warm-start needs --sweep-mode sequential (batched lanes "
            "solve independently from zero by design)")
    # fail before the reads when no card is present
    device = resolve_device(args.device)
    install_resilience(resilience_from_args(args))
    multiproc = False
    if args.multihost:
        multiproc = multihost.initialize(device=args.device)
        device = multihost.local_device()
    if multiproc:
        bad = [msg for flag, msg in (
            (args.training_diagnostics, "--training-diagnostics"),
            (args.sweep_mode == "batched", "--sweep-mode batched (its "
             "lanes share one design; the multi-process objective sums "
             "one lane over the ranks)"),
        ) if flag]
        if bad:
            raise SystemExit("multi-process --multihost training does not "
                             "support: " + ", ".join(bad))
    chief = multihost.is_chief()
    worker_dir = os.path.join("workers", f"proc-{multihost.process_index()}")
    run_logger = RunLogger(args.output_dir if chief else os.path.join(
        args.output_dir, worker_dir))
    debug_nans = _objective.debug_nans()
    _objective.set_debug_nans(debug_nans or args.debug_nans)
    # telemetry before the first event; a non-chief process traces under
    # its own workers/ directory
    telemetry = DriverTelemetry(
        args, "train_glm", subdir=None if chief else worker_dir,
        started=dict(task=task.value, output_dir=args.output_dir))
    profile_dir = (os.path.join(args.output_dir, "profile")
                   if args.profile else None)
    # the chief's writer service; "Save models" is its join
    saver = BackgroundSaver() if chief else None
    try:
        evaluators = parse_evaluators(
            [e for e in args.evaluators.split(",") if e])
        # grouped evaluators' id tags, read as id columns of both files
        id_columns = tuple(dict.fromkeys(
            e.id_tag for e in evaluators if e.id_tag))
        reader = AvroDataReader(
            shard_configs=(
                FeatureShardConfig("global", feature_bags=None,
                                   has_intercept=not args.no_intercept),),
            input_columns=parse_input_columns(args.input_columns))
        with timed("Read training data", run_logger):
            if multiproc:
                # this process's share of the files, then one feature
                # index (and id-tag vocabulary) agreed by every process
                from photon_ml_tpu_torch.game.multiprocess import (
                    process_file_share,
                    reconcile_global_ids,
                )

                data, index_maps, vocabs = reader.read(
                    process_file_share(reader, args.training_data),
                    id_columns=id_columns)
                data, index_maps, _ = reconcile_global_ids(
                    data, index_maps, vocabs, id_columns)
            else:
                data, index_maps, _ = reader.read(args.training_data,
                                                  id_columns=id_columns)
        imap = index_maps["global"]

        with timed("Validate data", run_logger):
            validate_game_data(data, task,
                               DataValidationType(args.data_validation))

        shard = data.shards["global"]
        norm_type = NormalizationType(args.normalization)
        normalization = NoNormalization
        stats = None
        if norm_type != NormalizationType.NONE or args.summarization_output:
            with timed("Summarize features", run_logger):
                # global statistics when rows span processes, so every
                # process builds the same normalization
                stats = FeatureDataStatistics.from_shard(shard).allreduce()
            if args.summarization_output and chief:
                write_avro_file(
                    os.path.join(args.output_dir, "summary.avro"),
                    stats.to_records(imap.names()),
                    FEATURE_SUMMARIZATION_RESULT_AVRO)
            if norm_type != NormalizationType.NONE:
                normalization = build_normalization(
                    norm_type, mean=stats.mean, variance=stats.variance,
                    max_magnitude=stats.max_magnitude,
                    intercept_index=imap.key_to_index.get(INTERCEPT_KEY),
                    device=device)

        lambdas = [float(x) for x in args.regularization_weights.split(";")
                   if x]
        config = GLMOptimizationConfiguration(
            optimizer=OptimizerType(args.optimizer),
            regularization=RegularizationContext(
                RegularizationType(args.regularization_type),
                alpha=args.elastic_net_alpha),
            optimizer_config=OptimizerConfig(
                max_iterations=args.max_iterations, tolerance=args.tolerance),
            variance_type=VarianceComputationType(args.variance_computation),
        )

        reg_mask = None
        if imap.has_intercept:
            mask = np.ones(len(imap), np.float32)
            mask[imap.key_to_index[INTERCEPT_KEY]] = 0.0
            reg_mask = torch.as_tensor(mask, device=device)

        if multiproc:
            # this rank's rows, padded to the row count every rank agreed
            glm_train = multihost.global_glm_data_multihost(GLMData(
                design=host_design_for_shard(
                    shard, dense=shard.dim <= DENSE_MAX_DIM,
                    dtype=args.design_dtype),
                labels=torch.as_tensor(data.labels),
                offsets=torch.as_tensor(data.offsets),
                weights=torch.as_tensor(data.weights)), device)
        else:
            glm_train = _to_glm_data(data, "global", args.design_dtype,
                                     device)
        initial = None
        if args.warm_start:
            warm_path = os.path.join(args.warm_start, "best", "model.avro")
            if not os.path.exists(warm_path):
                warm_path = os.path.join(args.warm_start, "model.avro")
            with timed("Load warm start", run_logger):
                prior = load_glm_model(warm_path, imap, device=device)
            # the sweep optimizes in transformed space; a saved model's
            # coefficients are in the original one
            w_orig = prior.coefficients.means
            initial = (w_orig if normalization.is_identity
                       else normalization.original_to_model(w_orig))

        with timed("Train", run_logger), profiled(profile_dir):
            if args.sweep_mode == "batched":
                trained = train_glm_sweep_batched(
                    task, glm_train, lambdas, config,
                    normalization=normalization, reg_mask=reg_mask)
            else:
                trained = train_glm_sweep(
                    task, glm_train, lambdas, config,
                    normalization=normalization, reg_mask=reg_mask,
                    initial=initial, distributed=multiproc)
            # the last solve finishes inside this stage
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        for tm in trained:
            run_logger.metric(stage="train",
                              regularization_weight=tm.regularization_weight,
                              value=float(tm.result.value),
                              iterations=int(tm.result.iterations),
                              converged=bool(tm.result.converged),
                              grad_norm=float(tm.result.grad_norm))
            log_optimizer_trace(
                tm.result, f"lambda={tm.regularization_weight:g}", run_logger)

        # divergence guard: each lambda is an independent solve, so there
        # is nothing to roll back to; rollback and freeze drop the
        # diverged lambdas from selection and continue degraded
        diverged = [tm for tm in trained
                    if not bool(torch.isfinite(
                        tm.model.coefficients.means).all())]
        if diverged:
            bad = [tm.regularization_weight for tm in diverged]
            for w in bad:
                GLOBAL_BUS.post("divergence_detected", driver="train_glm",
                                regularization_weight=w)
            if args.on_divergence == "fail":
                raise DivergenceError(
                    f"GLM sweep diverged at lambda(s) {bad} (non-finite "
                    f"coefficients); re-run with --on-divergence=rollback "
                    f"to drop them from selection, or raise the "
                    f"regularization / lower the normalization scale")
            if len(diverged) == len(trained):
                raise DivergenceError(
                    f"every lambda in the sweep diverged ({bad}); nothing "
                    f"to select — fix the optimization configuration")
            for w in bad:
                GLOBAL_BUS.post("coordinate_frozen", driver="train_glm",
                                regularization_weight=w)
            trained = [tm for tm in trained if tm not in diverged]

        # every lambda's model is final here: its writes overlap the
        # validation read, scoring and selection below (the evaluation is
        # not part of the written files)
        def save(model, out_dir, model_id):
            save_glm_model(os.path.join(out_dir, "model.avro"), model, imap,
                           model_id=model_id)
            save_glm_model_text(os.path.join(out_dir, "model.txt"), model,
                                imap)

        if chief:
            saver.submit_file_write(
                imap.save, os.path.join(args.output_dir,
                                        "feature-index.json"),
                label="io.save.index")
            for tm in trained:
                model_id = f"lambda-{tm.regularization_weight:g}"
                out_dir = os.path.join(args.output_dir, "all", model_id)
                saver.submit(
                    lambda tm=tm, out_dir=out_dir, model_id=model_id:
                        save(tm.model, out_dir, model_id),
                    label="io.save.model", path=out_dir)

        best_idx = 0
        glm_val = None
        # the diagnostics read the validation data too (the fitting curve,
        # out-of-sample HL), also without evaluators
        if args.validation_data and (evaluators or args.training_diagnostics):
            reader_v = AvroDataReader(shard_configs=reader.shard_configs,
                                      index_maps=index_maps,
                                      input_columns=reader.input_columns)
            with timed("Read validation data", run_logger):
                vdata, _, _ = reader_v.read(args.validation_data,
                                            id_columns=id_columns)
            glm_val = _to_glm_data(vdata, "global", args.design_dtype,
                                   device)
        if glm_val is not None and evaluators:
            with timed("Validate models", run_logger):
                best_idx, trained = validate_and_select(
                    trained, evaluators, glm_val,
                    id_tags=vdata.id_columns)
            for tm in trained:
                run_logger.metric(
                    stage="validate",
                    regularization_weight=tm.regularization_weight,
                    **tm.evaluation.as_dict())
        best = trained[best_idx]
        if chief:
            # the winner is known only now; the rest has been writing since
            # the sweep ended
            best_dir = os.path.join(args.output_dir, "best")
            saver.submit(lambda: save(best.model, best_dir, "best"),
                         label="io.save.model", path=best_dir)
            with timed("Save models", run_logger):
                saver.join()
        report_path = None
        if args.training_diagnostics:
            with timed("Diagnostics", run_logger):
                report_path = _run_diagnostics(
                    args, task, best, glm_train, glm_val, shard, stats, imap,
                    config, normalization, reg_mask, run_logger)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        result = {
            "best_lambda": best.regularization_weight,
            "best_evaluation": (best.evaluation.as_dict()
                                if best.evaluation else None),
            "output_dir": args.output_dir,
            "diagnostics_report": report_path,
        }
        # every process returns once the chief's outputs are complete
        multihost.barrier()
        if chief:
            # a supervised run hands its result to the supervisor
            write_result_file(result)
        return result
    finally:
        if saver is not None:
            saver.close()
        telemetry.close()
        _objective.set_debug_nans(debug_nans)
        run_logger.close()


if __name__ == "__main__":
    run()
