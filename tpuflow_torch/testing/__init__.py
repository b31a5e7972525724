"""Test support of the port (counterpart of ``tpuflow/testing``): the
fault-injection plan and its hooks (``faults``), and the per-member
record of an elastic gang's ``train_gpt`` run (``elastic_record``)."""
