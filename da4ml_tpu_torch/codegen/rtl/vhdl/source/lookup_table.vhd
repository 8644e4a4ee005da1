-- ROM lookup (DAIS opcode 8): o = rom(a). The .mem file uses the same
-- padded/rolled layout as the Verilog twin; entries are read with textio.
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;
use std.textio.all;

entity lookup_table is
    generic (WA : integer := 8; WO : integer := 8; MEMFILE : string := "table.mem");
    port (
        a : in std_logic_vector(WA - 1 downto 0);
        o : out std_logic_vector(WO - 1 downto 0)
    );
end entity;

architecture rtl of lookup_table is
    type rom_t is array (0 to 2 ** WA - 1) of std_logic_vector(WO - 1 downto 0);

    impure function load_rom return rom_t is
        file f : text open read_mode is MEMFILE;
        variable l : line;
        variable entry : std_logic_vector(WO - 1 downto 0);
        variable rom : rom_t := (others => (others => 'X'));
        variable idx : integer := 0;
        variable ok : boolean;
    begin
        while not endfile(f) and idx < 2 ** WA loop
            readline(f, l);
            hread(l, entry, ok);
            if ok then
                rom(idx) := entry;
            end if;
            idx := idx + 1;
        end loop;
        return rom;
    end function;

    constant rom : rom_t := load_rom;
begin
    o <= rom(to_integer(unsigned(a)));
end architecture;
