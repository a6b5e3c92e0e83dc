"""Share of its roofline that the shelf best-fit-decreasing kernel reaches
(csrc/shelf_bfd.cu: shelf_bfd_warp_kernel or shelf_bfd_wide_kernel), by
the reference's counts of the checked histograms."""

from portbench import readers


def read(record):
    return readers.kernel_roofline_pct(
        record, "shelf_bfd", "shelf_bfd", ("shelf_bfd",))
