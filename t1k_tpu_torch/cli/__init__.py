"""Command-line entry points of the PyTorch/CUDA port."""

import re

_NEG_NUM = re.compile(r"^-\d+(\.\d+)?([eE][+-]?\d+)?$")

# single-value flags whose values are legitimately negative (the
# reference getopt consumes them; argparse would read them as the
# -1/-2 options these parsers register)
_NEG_VALUE_FLAGS = {"--squaremMinAlpha", "--alleleDigitUnits"}


def fold_negative_values(argv):
    """Make reference-style negative option values argparse-safe:
    `--squaremMinAlpha -0.5` -> `--squaremMinAlpha=-0.5`.  Only known
    value-taking flags are touched."""
    out, i = [], 0
    while i < len(argv):
        a = argv[i]
        if (a in _NEG_VALUE_FLAGS and i + 1 < len(argv)
                and _NEG_NUM.match(argv[i + 1])):
            out.append(a + "=" + argv[i + 1])
            i += 2
        else:
            out.append(a)
            i += 1
    return out
