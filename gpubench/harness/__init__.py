"""The harness's parts: the cell's files, the timed window, the traced
run's reduction, the roofline arithmetic and the check of the outputs."""
