"""How many torch operations a function dispatches, by kind.

On the card each operation that is not a view is (at least) one kernel
launch, so these counts bound an eager path's host time from below.
"""

import collections

from torch.utils._python_dispatch import TorchDispatchMode

# the operator names that make a view (no launch)
VIEW_OPS = ("view", "expand", "slice", "select", "transpose", "unsqueeze",
            "squeeze", "permute", "alias", "as_strided", "t.default",
            "detach", "split", "unbind", "diagonal")


def op_kind(func) -> str:
    """'view', 'prims' (torch._refs decompositions dispatch them) or
    'op'."""
    name = str(func)
    if any(w in name for w in VIEW_OPS):
        return "view"
    return "prims" if name.startswith("prims.") else "op"


def count_ops(fn, tag=lambda: None) -> collections.Counter:
    """{(tag(), kind): operations} that `fn()` dispatches; `tag` names
    the stage each operation is counted under."""
    counts = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[(tag(), op_kind(func))] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return counts


def launches(counts) -> int:
    """The operations of `counts` that are not views."""
    return sum(n for (_, kind), n in counts.items() if kind != "view")
