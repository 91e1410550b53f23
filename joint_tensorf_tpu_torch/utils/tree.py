"""Nested parameter trees (dicts and lists of tensors or arrays, as the JAX
package keeps an MLP's or a planar image's parameters) to and from flat
{dotted name: leaf} dicts, the form the port's Adam takes: list items are
named by their index ({"feat": [{"w": a}]} -> {"feat.0.w": a})."""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts / lists -> {dotted name: leaf}; ``prefix`` names the
    root (a leaf at the root is named ``prefix`` itself)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        if v is not None:
            out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict, prefix: str = ""):
    """The inverse of flatten, for the names under ``prefix`` (None if
    there is none): levels whose keys are all digits become lists."""
    if prefix in flat:
        return flat[prefix]
    head = f"{prefix}." if prefix else ""
    root: dict = {}
    for name, leaf in flat.items():
        if not name.startswith(head):
            continue
        *path, last = name[len(head):].split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return _lists(root) if root else None


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}
