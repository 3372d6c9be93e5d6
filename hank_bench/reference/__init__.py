"""Plain references of the model families, one module each, named as the
configurations' `family`. They import nothing of the program."""
