"""Test support of the port (counterpart of ``tpuflow/testing``): the
fault-injection plan and its hooks (``faults``)."""
