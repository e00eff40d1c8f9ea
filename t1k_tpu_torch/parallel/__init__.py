"""Multi-process and multi-device execution of the port: the pipeline
driver's processes, the sharded EM, its dry run and its scaling bench."""
