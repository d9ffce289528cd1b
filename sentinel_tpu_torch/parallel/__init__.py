"""The pod: many shards of the step acting as one rate limiter for
cluster-mode rules (port of ``sentinel_tpu/parallel/``)."""
