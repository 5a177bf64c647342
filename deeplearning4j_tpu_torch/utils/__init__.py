"""Utilities of the port: counterpart of ``deeplearning4j_tpu.utils``
(``serialization``, ``preemption``, ``resources``; the rest waits in ROADMAP queue 1
item 10)."""
