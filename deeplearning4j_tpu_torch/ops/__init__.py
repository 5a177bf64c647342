"""Port-local operations (counterparts of ``deeplearning4j_tpu.ops``)."""
