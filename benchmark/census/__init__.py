"""The benchmark's yardstick: operation and byte counts from shapes and
from the samples a step's inputs need (counts.py), and frozen copies of the
port's sound arithmetic (frozen.py)."""
