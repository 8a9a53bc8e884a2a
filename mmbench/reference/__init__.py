"""Plain references of what the benchmark's cells compare.

Plain PyTorch, written from the published conventions (3DEqualizer's
classic lens, compositor ST maps).  They import nothing of the
program under test and take nothing it made: the benchmark hands both
sides the same inputs, and the references work out again whatever the
program derives from them.
"""
