"""Seconds from the process's start to the first timed step or scan (host
clock): imports, the drive and the weights, the program's set-up and its
warm-up."""


def read(rec):
    return rec.setup_s
