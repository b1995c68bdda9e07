"""The benchmark's plain reference: host assembly and an unfused IPCS loop
in plain torch, sharing no code with the program under test."""
