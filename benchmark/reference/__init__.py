"""Plain references the checks compare the program with; they import nothing of the program."""
