"""The DL4J network stack of the port (counterpart of
``deeplearning4j_tpu.nn``): ``multilayer``, ``graph``, ``graph_conf``,
``conf/`` and their helpers."""
