"""The port's worked example and soak (do.py, soak.py: the twins of
examples/do.py and scripts/soak.py), and measuring tools that no
pipeline path needs."""
