"""A training window's model operations over its time and the cards' bf16
peak (989 TFLOP/s a card): the convolutions of every step, forward, input
gradients and the trainable weights' gradients, counted from shapes
(benchmark/harness/costs.py); recomputation not counted. (A serving
window's share is ``mfu.serve.py``.)"""

from benchmark.harness.costs import PEAK_BF16


def read(run):
    ops = run["costs"]["train_ops_per_step"] * run["steps"]
    return ops / run["window_s"] / (PEAK_BF16 * run["world"]) * 100.0
