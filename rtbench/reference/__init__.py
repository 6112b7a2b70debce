"""The benchmark's plain reference: ``portref``, a frozen copy of the port's plain paths."""
