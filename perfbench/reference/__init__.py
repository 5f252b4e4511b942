"""The benchmark's plain reference: frozen copies of the port's plain code at commit 49129b2. Nothing here imports the program."""
