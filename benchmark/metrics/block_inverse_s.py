"""Seconds a solve spends building its element blocks' explicit inverses
and probing their refinement rounds: the tracer stage
``factorize/block-inverse`` of a steady ``"schur_direct"`` solve.  The
probe reads its error on the host, so the span holds the inverses' device
time too.  A program without the span gives nothing."""


def read(run):
    return run.stage_seconds("factorize/block-inverse")
