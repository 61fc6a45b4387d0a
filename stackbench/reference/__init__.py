"""The plain reference the check compares the program with."""
