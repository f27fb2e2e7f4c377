"""The plain reference: frozen input generators, the plain RTAC fixpoint and a
plain MAC search. Imports nothing of the port."""
