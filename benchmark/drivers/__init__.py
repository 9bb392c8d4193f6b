"""Drivers: one per kind of traffic loop, named by a traffic file's `driver` key. A
driver builds the program and its inputs from the seed (`setup`), runs one unit of
traffic (`unit`), reports the window's end-to-end metrics, frees the program
(`release`) and reads what its outputs are held to (`readings`)."""
