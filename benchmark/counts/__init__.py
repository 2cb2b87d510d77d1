"""Operation and byte counts of the program's hand-written kernels, one
module a kernel: ``KERNEL`` (a regular expression for the kernel's name in
the device trace) and ``launches(statics, passes)``, the work a launch
needs as ``[(bytes, operations, peak operations a second)]`` for the
pipeline passes of a window. A pass is ``(pairs, scales)``: a batch of
``pairs`` pairs through ``scales`` scales (its precompute once, every
scale's patches once). Bytes count every input read once and every output
written once; where the operations depend on the data, only the part that
does not is counted, so a bound is never above the least time."""
