"""Weight-list algebra used by every aggregation path (counterpart of
``elephas_tpu/utils/functional_utils.py``).

``add_params``, ``subtract_params``, ``divide_by``, ``scale_params``,
``get_neutral`` and ``average_params`` over weight lists: a leaf is an
array (numpy, or a torch tensor), and lists, tuples and dicts of leaves
nest, as the reference's ``jax.tree.map`` walks them. Each leaf takes the
same numpy operation the reference applies, so on numpy inputs the results
are bit-equal to the reference's.
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), keeping the containers' types."""
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError(
                f"parameter lists differ in length: {[len(tree), *map(len, rest)]}"
            )
        return type(tree)(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    if isinstance(tree, dict):
        if any(set(r) != set(tree) for r in rest):
            raise ValueError("parameter dicts differ in keys")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def add_params(p1, p2):
    """Elementwise ``p1 + p2`` over two matching weight lists."""
    return tree_map(lambda a, b: a + b, p1, p2)


def subtract_params(p1, p2):
    """Elementwise ``p1 - p2`` over two matching weight lists."""
    return tree_map(lambda a, b: a - b, p1, p2)


def divide_by(params, num_workers):
    """Divide every leaf by ``num_workers`` (aggregation → average)."""
    return tree_map(lambda a: a / num_workers, params)


def scale_params(params, factor):
    """Multiply every leaf by ``factor``."""
    return tree_map(lambda a: a * factor, params)


def get_neutral(params):
    """Zeros of the same structure and shapes: the additive identity."""
    return tree_map(lambda a: a * 0, params)


def average_params(param_list):
    """Average a non-empty sequence of matching weight lists (the
    driver-side collect-and-average of the synchronous reference)."""
    if not param_list:
        raise ValueError("average_params: empty parameter list")
    total = param_list[0]
    for p in param_list[1:]:
        total = add_params(total, p)
    return divide_by(total, len(param_list))
