"""The benchmark's harness: finds a cell's files by name, drives its
window, reads its metrics and prints its result line."""
