"""Plain references the benchmark holds the program against; they import nothing of it."""
