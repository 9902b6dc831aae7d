"""Named lock factories.

Engine code creates its locks through these factories with a canonical
rank name (short module path + owner + attr, e.g.
``"storage.store.TableStore._mu"``), the spelling the reference's lock
sanitizer keys on.  The port has no lock sanitizer yet, so the name is
documentation and the factories return the raw ``threading``
primitives.
"""

from __future__ import annotations

import threading

__all__ = ["Lock", "RLock", "Condition"]


def Lock(name: str = ""):
    """A mutex; ``name`` is the lock's canonical rank name."""
    return threading.Lock()


def RLock(name: str = ""):
    """A reentrant lock; ``name`` is the lock's canonical rank name."""
    return threading.RLock()


def Condition(lock=None, name: str = ""):
    """A condition variable over ``lock`` (a fresh reentrant lock when
    None); ``name`` is the lock's canonical rank name."""
    return threading.Condition(lock)
