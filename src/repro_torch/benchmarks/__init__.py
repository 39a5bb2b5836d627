"""The paper's tables and figures on the port (mechanism reproductions at
the reference benchmarks' scale; ``python -m repro_torch.benchmarks.run``)."""
