"""Cohort tools of the port: the SMART-seq pipeline (``smartseq``), the
cross-sample matrix (``merge``), copy-number inference, sample grouping,
SAM-hit filtering and the read simulator, counterparts of
``t1k_tpu/tools/``."""
