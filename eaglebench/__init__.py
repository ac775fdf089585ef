"""The port's benchmark: cells of repro_torch on the card, each a
configuration under a traffic mix, driven from BENCHMARK.json."""
