"""The benchmark's yardsticks: the work counter, the peaks and the trace reader."""
