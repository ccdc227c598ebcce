"""bank_pass_roofline.batch: the collision bank pass's share of its
roofline, in %: the least time its launches in the profiled sub-window
could take (bytes over the peak bandwidth or operations over the float32
peak, whichever is larger, from each launch's shapes) over their measured
device time.  The kernels are the instantiations of ``bank_pass`` and
``bank_pass_small`` (``armour_tpu_torch/csrc/collision_bank.cu``)."""

from armour_bench.trace import bank_pass_roofline


def read(record):
    return bank_pass_roofline(record, ("bank_pass", "bank_pass_small"))
