"""Share of its roofline that the fused assignment kernel reaches
(csrc/fused_assign.cu: assign_kernel and its demand_reduce_kernel per
launch), by the reference's counts of the checked operands."""

from portbench import readers


def read(record):
    return readers.kernel_roofline_pct(
        record, "fused_assign", "assign_kernel",
        ("assign_kernel", "demand_reduce_kernel"))
