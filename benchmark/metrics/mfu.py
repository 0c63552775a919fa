"""mfu: The window's operations (its steps', or its batches' and
refreshes', counted from the shapes by ``benchmark/work``) over its time,
as a share of the H100's 67 TFLOP/s float32 peak."""

from benchmark.work.common import F32_FLOPS


def read(record):
    return record["work"]["window_flops"] / record["window_s"] \
        / F32_FLOPS * 100
