"""The benchmark's harness: resolving a cell from its files, making weights and frames
from the seed, driving the program, tracing, and judging its outputs."""
