"""The yardstick: peaks, work models, kernel names and the profiler
arithmetic, frozen here so that no change to the program moves them."""
