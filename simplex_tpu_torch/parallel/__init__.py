"""Sharded solving and the scenario fleet over ``torch.distributed``: the
port of ``simplex_tpu.parallel`` (``group`` replaces the JAX mesh,
``sharded`` holds the column-sharded solve)."""
