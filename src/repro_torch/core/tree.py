"""Nested dicts of tensors, walked as the reference walks its pytrees.

The reference keeps parameters, gradients and optimizer moments as JAX
pytrees of dicts; the port keeps them as nested ``dict``s (and
``nn.Module``s whose parameters are registered under the same keys).
``flatten_with_path`` visits the leaves in JAX's order (dict keys
sorted at every level, list items by index), and ``path_str`` spells a
path the way ``"/".join(str(k) for k in path)`` spells a JAX key path
(``['layers']/['b0_attn']/['attn']/['wq']``; a list index as ``[0]``,
as in the hybrid's ``['tail']/[0]/['rec']/['w_x']``), which is what the
per-leaf seeds of the secure aggregation hash.
"""

from __future__ import annotations

from typing import Any, Callable


def _walk(node, prefix, out) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], prefix + (k,), out)
    elif isinstance(node, list):
        for i, child in enumerate(node):
            _walk(child, prefix + (i,), out)
    else:
        out.append((prefix, node))


def flatten_with_path(tree) -> list[tuple[tuple[str | int, ...], Any]]:
    """``[(path, leaf), ...]`` with dict keys sorted at every level and
    list items in order (an int key).

    The walk is a module-level function: a nested one that calls itself
    is a reference cycle holding the list, so the leaves would outlive
    the caller's last reference until the garbage collector runs (5.5
    GB of layers drawn by ``transformer.init`` at falcon-mamba-7b's
    size)."""
    out: list = []
    _walk(tree, (), out)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _lists(node):
    """``node`` with every dict keyed by the ints ``0..n-1`` made a list."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def unflatten(paths, values) -> dict:
    """The nested tree with ``values`` at ``paths``: dicts, and lists
    where the keys are list indices (ints)."""
    out: dict = {}
    for path, value in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return _lists(out)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure)."""
    flat = flatten_with_path(tree)
    others = [dict(flatten_with_path(t)) for t in rest]
    return unflatten([p for p, _ in flat],
                     [fn(leaf, *(o[p] for o in others)) for p, leaf in flat])


def path_str(path) -> str:
    """A key path as the reference prints a JAX key path."""
    return "/".join(f"[{k!r}]" for k in path)
