"""The MSV filter's share of its roofline: the calls' MSV bound over the
device time of bias_kernel, msv_kernel and msv_cta_kernel."""

from hmmbench import readers


def read(run):
    return readers.msv_roofline(run)
