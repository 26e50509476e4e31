"""The yardstick's arithmetic: the chip's peaks and the operations and
bytes of each kernel and model step, computed from shapes alone."""
