"""The JAX drivers' options that the port does not have yet.

Each driver keeps a table of them: keyword -> (the value that means "off",
the ROADMAP queue 1 item that ports it); a tuple lists several off values.
A driver passes every keyword it does not take itself to
:func:`refuse_unported`, so a keyword set to its off value is accepted, one
set to anything else raises, naming the item, and one the JAX driver does
not take either is a ``TypeError``, as for any function.
"""

from __future__ import annotations


def refuse_unported(options: dict, not_ported: dict):
    for key, value in options.items():
        if key not in not_ported:
            raise TypeError(f"train() got an unexpected keyword argument "
                            f"{key!r}")
        off, item = not_ported[key]
        offs = off if isinstance(off, tuple) else (off,)
        if value not in offs:
            raise NotImplementedError(
                f"{key}={value!r} is not ported yet (ROADMAP queue 1 item "
                f"{item}); the port runs {key}={offs[0]!r}")
