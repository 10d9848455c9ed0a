"""The window's peak of allocated device memory, MiB."""

from hmmbench import readers


def read(run):
    return readers.peak_device_mib(run)
