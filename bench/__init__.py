"""The benchmark of ``repro_torch``: cells of BENCHMARK.json run through the
port's ServingEngine on one card, judged against a plain PyTorch reference
(see README.md)."""
