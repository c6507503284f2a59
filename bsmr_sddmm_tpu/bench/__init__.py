"""Benchmark harness: sweep runner, log analyzer, figure plotters.

A port of the reference's scripts/ layer (SURVEY.md section 2c):
test_script.sh -> runner, analyze_results.cpp -> analyze, plot_*.py -> plot.
"""

from bsmr_sddmm_tpu.bench.analyze import (MatrixResult, analyze_logs,
                                          write_results_csv)
from bsmr_sddmm_tpu.bench.runner import run_matrix, run_suite

__all__ = ["MatrixResult", "analyze_logs", "write_results_csv",
           "run_matrix", "run_suite"]
