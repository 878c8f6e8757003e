"""Data parallelism over one process per device (``ddp.py``), the
counterpart of ``centernet_uda_tpu/parallel/``."""
