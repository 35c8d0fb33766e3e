"""Command-line tools of the port: sampling, HTTP serving (from a checkpoint or an exported
artifact), profiling, the network smoke test, TF checkpoint interop and data preparation."""
