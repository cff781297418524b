"""The benchmark's counts of work: the model's FLOPs from a configuration's
shapes (`flops`) and the least time of the unit op's kernels against the
card's data-sheet peaks (`bounds`). Frozen here so that no change to the
program can move the yardstick."""
