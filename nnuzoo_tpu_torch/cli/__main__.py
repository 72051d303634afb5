from .entry_points import main

if __name__ == "__main__":
    main()
