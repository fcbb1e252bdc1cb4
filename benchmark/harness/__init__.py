"""The benchmark's yardstick: what reads files, makes inputs from the
seed, reduces traces and decides `correct`; frozen so that a change to the
program cannot move it."""
