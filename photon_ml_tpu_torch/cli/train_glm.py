"""Single-GLM training from the command line (counterpart of
``photon_ml_tpu/cli/train_glm.py``, the reference's legacy GLM pipeline).

Read the training Avro → check the rows → when asked, summarize the
features and normalize → train one model per regularization weight
(sequentially with warm starts, or all lambdas as lanes of one batched
solve; L-BFGS, TRON, or OWL-QN where the regularization has an L1 part) →
score each on the validation data and select the best by the first
evaluator → write ``best/`` and ``all/lambda-*/`` (``model.avro`` and
``model.txt`` each) beside ``feature-index.json`` and, when asked,
``summary.avro``. The directory loads in either package.

    python -m photon_ml_tpu_torch train_glm --training-data train.avro \\
        --validation-data valid.avro --output-dir out \\
        --regularization-weights '10;1;0.1' --evaluators AUC

A shard of at most :data:`DENSE_MAX_DIM` columns trains on a dense design
(kernels 1, 3 and 4 on the card); a wider one on a
:class:`~photon_ml_tpu_torch.ops.design.ChunkedSparseDesign` in f32. It runs
on the card unless ``--device cpu`` asks for the CPU. Saves run in the
calling thread (the reference's background saver only overlaps them: the
bytes are the same). Flags of the reference that the port does not run
yet are accepted by the parser and raise :class:`NotImplementedError`
naming the flag.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.cli.config import (
    add_unported_flags,
    refuse_unported,
)
from photon_ml_tpu_torch.data_validation import validate_game_data
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation import parse_evaluators
from photon_ml_tpu_torch.game.data import GameData, design_dtype_of
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
from photon_ml_tpu_torch.glm.training import (
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
from photon_ml_tpu_torch.io.schemas import FEATURE_SUMMARIZATION_RESULT_AVRO
from photon_ml_tpu_torch.logging_util import (
    RunLogger,
    log_optimizer_trace,
    timed,
)
from photon_ml_tpu_torch.ops.design import ChunkedSparseDesign, DenseDesign
from photon_ml_tpu_torch.ops.normalization import (
    NoNormalization,
    build_normalization,
)
from photon_ml_tpu_torch.ops.objective import GLMData
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
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

#: the reference's flags this command does not run yet, with their argparse
#: settings: each is accepted and raises NotImplementedError when given
_UNPORTED_FLAGS = {
    "--training-diagnostics": {"action": "store_true"},
    "--diagnostic-bootstrap-replicates": {"type": int},
    "--profile": {"action": "store_true"},
    "--debug-nans": {"action": "store_true"},
    "--multihost": {"action": "store_true"},
    "--max-retries": {"type": int},
    "--retry-deadline-s": {"type": float},
    "--supervise": {"type": int},
    "--max-restarts": {"type": int},
    "--heartbeat-timeout-s": {"type": float},
    "--restart-deadline-s": {"type": float},
    "--telemetry-dir": {},
    "--telemetry-poll-s": {"type": float},
    "--metrics-port": {"type": int},
}


class DivergenceError(RuntimeError):
    """The sweep produced non-finite coefficients."""


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
    p.add_argument("--on-divergence", default="fail",
                   choices=["fail", "rollback", "freeze"],
                   help="only fail (raise on non-finite coefficients, "
                        "naming the lambdas) is ported")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solves run (default: the GPU; there is "
                        "no fall-back to the CPU)")
    add_unported_flags(p, _UNPORTED_FLAGS)
    return p


def _refuse_unported(args) -> None:
    if args.on_divergence != "fail":
        raise NotImplementedError(
            f"--on-divergence {args.on_divergence} is not ported")
    refuse_unported(args, _UNPORTED_FLAGS)


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


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    _refuse_unported(args)
    task = TaskType(args.task)
    if args.warm_start and args.sweep_mode == "batched":
        raise SystemExit(
            "--warm-start needs --sweep-mode sequential (batched lanes "
            "solve independently from zero by design)")
    # fail before the reads when no card is present
    device = resolve_device(args.device)
    run_logger = RunLogger(args.output_dir)
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
            data, index_maps, _ = reader.read(args.training_data,
                                              id_columns=id_columns)
        imap = index_maps["global"]

        with timed("Validate data", run_logger):
            validate_game_data(data, task,
                               DataValidationType(args.data_validation))

        shard = data.shards["global"]
        norm_type = NormalizationType(args.normalization)
        normalization = NoNormalization
        if norm_type != NormalizationType.NONE or args.summarization_output:
            with timed("Summarize features", run_logger):
                stats = FeatureDataStatistics.from_shard(shard).allreduce()
            if args.summarization_output:
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

        glm_train = _to_glm_data(data, "global", args.design_dtype, device)
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

        with timed("Train", run_logger):
            if args.sweep_mode == "batched":
                trained = train_glm_sweep_batched(
                    task, glm_train, lambdas, config,
                    normalization=normalization, reg_mask=reg_mask)
            else:
                trained = train_glm_sweep(
                    task, glm_train, lambdas, config,
                    normalization=normalization, reg_mask=reg_mask,
                    initial=initial)
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

        # divergence guard: every lambda is an independent solve, so there
        # is nothing to roll back to; "fail" raises naming the lambdas
        bad = [tm.regularization_weight for tm in trained
               if not bool(torch.isfinite(
                   tm.model.coefficients.means).all())]
        if bad:
            raise DivergenceError(
                f"GLM sweep diverged at lambda(s) {bad} (non-finite "
                f"coefficients); raise the regularization or lower the "
                f"normalization scale")

        best_idx = 0
        if args.validation_data and evaluators:
            reader_v = AvroDataReader(shard_configs=reader.shard_configs,
                                      index_maps=index_maps,
                                      input_columns=reader.input_columns)
            with timed("Read validation data", run_logger):
                vdata, _, _ = reader_v.read(args.validation_data,
                                            id_columns=id_columns)
            glm_val = _to_glm_data(vdata, "global", args.design_dtype,
                                   device)
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

        def save(model, out_dir, model_id):
            save_glm_model(os.path.join(out_dir, "model.avro"), model, imap,
                           model_id=model_id)
            save_glm_model_text(os.path.join(out_dir, "model.txt"), model,
                                imap)

        with timed("Save models", run_logger):
            imap.save(os.path.join(args.output_dir, "feature-index.json"))
            for tm in trained:
                model_id = f"lambda-{tm.regularization_weight:g}"
                save(tm.model, os.path.join(args.output_dir, "all",
                                            model_id), model_id)
            save(best.model, os.path.join(args.output_dir, "best"), "best")
        return {
            "best_lambda": best.regularization_weight,
            "best_evaluation": (best.evaluation.as_dict()
                                if best.evaluation else None),
            "output_dir": args.output_dir,
            "diagnostics_report": None,
        }
    finally:
        run_logger.close()


if __name__ == "__main__":
    run()
