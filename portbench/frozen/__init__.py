"""Frozen copies of what the benchmark measures with: the traffic's water
boxes, the element table, the model's work formulas, the kernel names of
the port's CUDA libraries and the card's peaks.  They are copies so that a
change to the port cannot move the yardstick; ``portbench/tests`` ties
each to the port's original as it stood when it was copied."""
