"""The Photon-ML Avro schemas, as Python dicts (a copy of
``photon_ml_tpu/io/schemas.py``).

Counterparts of ``photon-avro-schemas/src/main/avro/*.avsc``: the training
record (response/offset/weight/id + feature list of (name, term, value)),
the Bayesian linear model output (means + variances as name-term-value
lists), the scoring output, and per-feature summarization stats. Namespaces
kept Photon-compatible so files interchange with reference tooling.
"""

NAMESPACE = "com.linkedin.photon.avro.generated"

FEATURE_AVRO = {
    "type": "record",
    "name": "FeatureAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string", "default": ""},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_AVRO = {
    "type": "record",
    "name": "TrainingExampleAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "response", "type": "double"},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        # entity-id tags for GAME (userId, songId, ...) and grouped metrics
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
    ],
}

NAME_TERM_VALUE_AVRO = {
    "type": "record",
    "name": "NameTermValueAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string", "default": ""},
        {"name": "value", "type": "double"},
    ],
}

BAYESIAN_LINEAR_MODEL_AVRO = {
    "type": "record",
    "name": "BayesianLinearModelAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE_AVRO}},
        {"name": "variances",
         "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
         "default": None},
    ],
}

SCORING_RESULT_AVRO = {
    "type": "record",
    "name": "ScoringResultAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "predictionScore", "type": "double"},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
    ],
}

# Serving request/score log (serving/reqlog.py — the one sanctioned writer,
# telemetry hygiene rule 7). One record per SERVED REQUEST: the request id
# assigned at the HTTP layer, the model lineage that answered it, the
# per-stage timings the front end measured, and the full scored records
# (features + entity ids + score) so ``tools/reqlog_replay.py`` can re-score
# the exact inputs against the named lineage and assert bit-parity.
REQUEST_LOG_SCORED_RECORD_AVRO = {
    "type": "record",
    "name": "RequestLogScoredRecordAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
        # the served f32 score widened to double — exact, so replay
        # comparison is bit-level
        {"name": "score", "type": "double"},
        # optional ground truth attached AT REQUEST TIME (backfill/replay
        # clients that already know the outcome); most live traffic leaves
        # it null and the feedback joiner attaches labels later from an
        # external source keyed by request id. Readers decode with the
        # embedded writer schema, so old segments without the field stay
        # readable (feedback/joiner.py uses .get)
        {"name": "label", "type": ["null", "double"], "default": None},
    ],
}

# Ranked requests log their returned top-k (ids best-first + the served
# f32 scores widened to double) so ``tools/reqlog_replay.py`` can re-rank
# the logged request against the named lineage and assert the ids AND
# scores come back bit-identical.
REQUEST_LOG_TOPK_AVRO = {
    "type": "record",
    "name": "RequestLogTopKAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "k", "type": "long"},
        {"name": "ids", "type": {"type": "array", "items": "string"}},
        {"name": "scores", "type": {"type": "array", "items": "double"}},
    ],
}

REQUEST_LOG_AVRO = {
    "type": "record",
    "name": "RequestLogAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "requestId", "type": "string"},
        {"name": "ts", "type": "double"},  # wall-clock timestamp (epoch s)
        # which serving workload answered: "score" (records carry served
        # scores) or "rank" (records carry the REQUEST record; the
        # result lands in topk)
        {"name": "kind", "type": "string", "default": "score"},
        {"name": "modelVersion", "type": "long"},
        {"name": "modelLineage", "type": ["null", "string"], "default": None},
        {"name": "stageMs", "type": {"type": "map", "values": "double"},
         "default": {}},
        {"name": "records",
         "type": {"type": "array", "items": REQUEST_LOG_SCORED_RECORD_AVRO}},
        {"name": "topk", "type": ["null", REQUEST_LOG_TOPK_AVRO],
         "default": None},
    ],
}

# External label source for the feedback joiner (feedback/joiner.py): one
# record per observed outcome, keyed by the request id the serving front
# end assigned (and echoed to the client) plus the record's index within
# that request. The joiner matches these against logged
# RequestLogScoredRecordAvro rows to build incremental training data.
FEEDBACK_LABEL_AVRO = {
    "type": "record",
    "name": "FeedbackLabelAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "requestId", "type": "string"},
        {"name": "recordIndex", "type": "long", "default": 0},
        {"name": "label", "type": "double"},
    ],
}

FEATURE_SUMMARIZATION_RESULT_AVRO = {
    "type": "record",
    "name": "FeatureSummarizationResultAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string", "default": ""},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}
