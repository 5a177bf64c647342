"""Typed resilience outcomes (counterpart of ``deeplearning4j_tpu.resilience``)."""
