"""Rule datasources (port of ``sentinel_tpu/datasource/``): so far only
the JSON converters of the five rule families (``converters.py``), which
the rollout manager parses candidates with."""
