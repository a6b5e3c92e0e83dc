"""CUDA-graph captures the fused tick's program made over the run, warm-up
included (FusedTickProgram.captures): one per operand shape class, so 1
where every tick keeps the shape the door pads it to."""


def read(record):
    captures = record["counters"].get("captures")
    return None if captures is None else float(captures)
