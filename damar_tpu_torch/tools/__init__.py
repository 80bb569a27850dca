"""Measuring tools of the port that no pipeline path needs."""
