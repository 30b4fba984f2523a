# Negative-test fixtures for repro_torch.analysis
# (tests/test_torch_analysis.py).  These files are parsed by the
# analyzers, never imported or executed; no test_ prefix, so pytest does
# not collect them.
