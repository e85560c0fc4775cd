"""Tiles over the dispatch stage's launches (the pipeline's fusion
stats) of the window's passes."""


def read(rec):
    if rec.kind != "drain" or not rec.fusion["launches"]:
        return None
    return rec.fusion["tiles"] / rec.fusion["launches"]
